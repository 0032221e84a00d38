"""The data plane: images, shards, captions, readers and the feeder."""

"""MobileNetV2 encoder, adaptive-attention LSTM decoder, captioning facade."""

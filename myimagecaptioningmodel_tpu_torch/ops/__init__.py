"""Layer primitives, LSTM cell, attention, and the hand-written kernels."""

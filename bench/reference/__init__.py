"""The plain reference in float32 PyTorch: weights from the seed, the
model, AdamW, and the control's lower-precision product.  It imports
nothing of the program."""

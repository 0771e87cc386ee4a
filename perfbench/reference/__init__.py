"""The plain references that decide `correct`: plain PyTorch and NumPy,
nothing of the program."""

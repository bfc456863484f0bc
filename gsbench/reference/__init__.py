"""The plain reference: PyTorch alone, nothing of the program."""

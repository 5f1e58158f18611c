"""The plain reference the program's outputs are judged against: float32
PyTorch and float64 NumPy, importing nothing of the program."""

"""The plain reference: plain PyTorch and numpy, importing nothing of
the port."""

"""Image and reduction ops of the PyTorch port; K1/K2 live in ``canny``,
K3 in ``lgsx``."""

"""Panel data: the synthetic generator and the .npz loader."""

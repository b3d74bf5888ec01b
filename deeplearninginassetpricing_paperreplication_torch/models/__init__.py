"""The SDF-GAN networks in PyTorch."""

"""Test data of the port: BraTS npy cases and a synthetic generator."""

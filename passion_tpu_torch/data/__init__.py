"""Data of the port: BraTS npy datasets, augmentations, the prefetching
loader and a synthetic generator."""

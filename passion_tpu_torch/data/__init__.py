"""Data of the port: BraTS npy datasets, augmentations, the prefetching
loader, a synthetic generator and the offline preprocessing."""

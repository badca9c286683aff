from .loaders import (
    DataLoader,
    defocus_blur_dataset_loader,
    gaussian_noise_dataset_loader,
    motion_blur_dataset_loader,
    real_noise_dataset_loader,
)

from fastvim_tpu_torch.data.loader import (
    DataLoader,
    ImageFolderDataset,
    SyntheticDataset,
    create_imagenet_loader,
)

__all__ = [
    "DataLoader",
    "ImageFolderDataset",
    "SyntheticDataset",
    "create_imagenet_loader",
]

from fastvim_tpu_torch.data.cells import (
    CellDataset,
    CellLoader,
    SyntheticCellDataset,
    cell_augment,
    split_indices,
)
from fastvim_tpu_torch.data.loader import (
    DataLoader,
    ImageFolderDataset,
    SyntheticDataset,
    create_imagenet_loader,
)

__all__ = [
    "CellDataset",
    "CellLoader",
    "DataLoader",
    "ImageFolderDataset",
    "SyntheticCellDataset",
    "SyntheticDataset",
    "cell_augment",
    "create_imagenet_loader",
    "split_indices",
]

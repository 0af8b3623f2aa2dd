from fastvim_tpu_torch.data.cells import (
    CellDataset,
    CellLoader,
    SyntheticCellDataset,
    cell_augment,
    split_indices,
)
from fastvim_tpu_torch.data.detection import (
    CocoDetectionDataset,
    DetectionLoader,
    SyntheticDetectionDataset,
    create_detection_loader,
    lsj_transform,
)
from fastvim_tpu_torch.data.loader import (
    DataLoader,
    ImageFolderDataset,
    SyntheticDataset,
    create_imagenet_loader,
)
from fastvim_tpu_torch.data.segmentation import (
    ADE20KDataset,
    SegmentationLoader,
    SyntheticSegDataset,
    create_segmentation_loader,
)

__all__ = [
    "ADE20KDataset",
    "CellDataset",
    "CellLoader",
    "CocoDetectionDataset",
    "DataLoader",
    "DetectionLoader",
    "ImageFolderDataset",
    "SegmentationLoader",
    "SyntheticCellDataset",
    "SyntheticDataset",
    "SyntheticDetectionDataset",
    "SyntheticSegDataset",
    "cell_augment",
    "create_detection_loader",
    "create_imagenet_loader",
    "create_segmentation_loader",
    "lsj_transform",
    "split_indices",
]

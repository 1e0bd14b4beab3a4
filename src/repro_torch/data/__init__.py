from repro_torch.data.pipeline import OrderedDataset
from repro_torch.data.synthetic import make_classification, make_images

__all__ = ["OrderedDataset", "make_classification", "make_images"]

from repro_torch.data.pipeline import OrderedDataset
from repro_torch.data.synthetic import (lm_batch, make_classification,
                                        make_images, make_tokens)

__all__ = ["OrderedDataset", "lm_batch", "make_classification", "make_images",
           "make_tokens"]

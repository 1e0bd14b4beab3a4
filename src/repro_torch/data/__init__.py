from repro_torch.data.pipeline import (OrderedDataset, RoundPrefetcher,
                                       first_microbatch, rank_rows)
from repro_torch.data.synthetic import (lm_batch, make_classification,
                                        make_images, make_tokens)

__all__ = ["OrderedDataset", "RoundPrefetcher", "first_microbatch",
           "lm_batch", "make_classification", "make_images", "make_tokens",
           "rank_rows"]

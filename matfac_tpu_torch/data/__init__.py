from matfac_tpu_torch.data.csr import RatingMatrix
from matfac_tpu_torch.data.dataset import Data

__all__ = ["RatingMatrix", "Data"]

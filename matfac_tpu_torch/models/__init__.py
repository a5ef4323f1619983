from matfac_tpu_torch.models.base import MFState, ModelMF, init_state

__all__ = ["MFState", "ModelMF", "init_state"]

from matfac_tpu_torch.models.base import (MFState, ModelMF, ModelMFBias,
                                          init_state)
from matfac_tpu_torch.models.longtail import (ModelDropoutSigmoid,
                                              ModelInvPopMF,
                                              ModelPoissonDropout)

__all__ = ["MFState", "ModelMF", "ModelMFBias", "init_state",
           "ModelInvPopMF", "ModelDropoutSigmoid", "ModelPoissonDropout"]

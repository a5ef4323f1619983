"""The plain references: PyTorch and NumPy in f32 with TF32 off, one file
per entry a traffic mix names. They import nothing of the program
(``matfac_tpu_torch``), of JAX or of the JAX package; they work out again
from the inputs and the seed what the program derives from them."""

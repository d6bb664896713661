"""Training checkpoints in the reference's npz file format."""
from repro_torch.checkpoint.checkpoint import (load_pytree, restore, save,
                                               save_pytree)

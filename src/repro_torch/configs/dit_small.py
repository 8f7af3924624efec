"""CPU-scale DiT used for the paper-claims validation experiments."""
from repro_torch.configs.base import DiTConfig

CONFIG = DiTConfig(
    arch_id="dit-small", n_layers=8, d_model=128, n_heads=8, d_ff=512,
    patch_size=2, in_channels=4, dtype="float32",
    source="in-repo small DiT (paper-claims validation at CPU scale)",
)

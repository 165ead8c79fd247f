"""Yi-6B: llama-arch dense transformer with GQA (kv=4).
[arXiv:2403.04652; hf:01-ai/Yi-6B]"""

from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="yi-6b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000, head_dim=128, rope_theta=5_000_000.0,
    dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="yi-6b-reduced", n_layers=2, d_model=128, n_heads=8, n_kv_heads=1,
    d_ff=344, vocab=512, head_dim=16, dtype="float32", remat="none",
)

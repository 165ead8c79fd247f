"""Granite-MoE 3B-A800M: 40 experts top-8, GQA kv=8.
[hf:ibm-granite/granite-3.0-3b-a800m-base]"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="granite-moe-3b-a800m", n_layers=32, d_model=1536, n_heads=24,
    n_kv_heads=8, d_ff=512, vocab=49155, head_dim=64,
    moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512, n_shared=0,
                  capacity_factor=1.25),
    dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="granite-reduced", n_layers=2, d_model=96, n_heads=6, n_kv_heads=2,
    d_ff=64, vocab=512, head_dim=16,
    moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=64, n_shared=0,
                  capacity_factor=8.0),  # drop-free at smoke scale
    dtype="float32", remat="none",
)

"""Moonlight-16B-A3B (kimi/moonshot): MoE, 64 experts top-6 (+2 shared),
DeepSeek-V3-style. [hf:moonshotai/Moonlight-16B-A3B]"""

from repro_torch.models.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=1408, vocab=163840, head_dim=128,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  capacity_factor=1.25),
    dtype="bfloat16", remat="full",
    train_layout="tpsp", train_microbatches=2,   # §Perf: EP+TP with 2-way
                           # grad accumulation is the config that fits HBM
)

REDUCED = LMConfig(
    name="moonshot-reduced", n_layers=2, d_model=128, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab=1024, head_dim=32,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=128, n_shared=1,
                  capacity_factor=8.0),  # drop-free at smoke scale
    dtype="float32", remat="none",
)

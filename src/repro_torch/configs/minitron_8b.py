"""Minitron-8B: width-pruned Nemotron-4, GQA kv=8, 256k vocab.
[arXiv:2407.14679; hf:nvidia/Minitron-8B-Base]"""

from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="minitron-8b", n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=16384, vocab=256000, head_dim=128, dtype="bfloat16", remat="full",
    train_layout="tpsp", train_microbatches=2,
)

REDUCED = LMConfig(
    name="minitron-8b-reduced", n_layers=2, d_model=128, n_heads=8,
    n_kv_heads=2, d_ff=512, vocab=1024, head_dim=16, dtype="float32",
    remat="none",
)

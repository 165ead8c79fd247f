"""MiniCPM3-4B: multi-head latent attention (MLA), 62 layers.
[hf:openbmb/MiniCPM3-4B]"""

from repro_torch.models.attention import MLAConfig
from repro_torch.models.transformer import LMConfig

FAMILY = "lm"

CONFIG = LMConfig(
    name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab=73448, head_dim=64, attention="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_dim=64,
                  qk_rope_dim=32, v_head_dim=64),
    dtype="bfloat16", remat="full",
)

REDUCED = LMConfig(
    name="minicpm3-4b-reduced", n_layers=2, d_model=128, n_heads=4,
    n_kv_heads=4, d_ff=256, vocab=512, head_dim=32, attention="mla",
    mla=MLAConfig(q_lora_rank=48, kv_lora_rank=32, qk_nope_dim=16,
                  qk_rope_dim=8, v_head_dim=32),
    dtype="float32", remat="none",
)

"""llama4-maverick-400b-a17b [moe] — 128 experts top-1 + shared expert,
alternating (SWA-8192 dense, full-attn MoE) layer pairs, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.config import ModelConfig

MODEL = ModelConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=8192, vocab_size=202048, head_dim=128,
    num_experts=128, experts_per_token=1, moe_shared_expert=True,
    sliding_window=8192,
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
)

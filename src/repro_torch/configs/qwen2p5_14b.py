"""qwen2.5-14b [dense] — GQA with QKV bias. [hf:Qwen/Qwen2.5-0.5B]"""
from repro_torch.config import ModelConfig

MODEL = ModelConfig(
    name="qwen2.5-14b", family="dense",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8,
    d_ff=13824, vocab_size=152064, head_dim=128, qkv_bias=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen2.5-0.5B",
)

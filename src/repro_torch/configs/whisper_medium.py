"""whisper-medium [audio] — enc-dec transformer backbone; conv/mel frontend
is a stub (input_specs provides frame embeddings). [arXiv:2212.04356]"""
from repro_torch.config import ModelConfig

MODEL = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, encoder_layers=24, d_model=1024,
    num_heads=16, num_kv_heads=16, d_ff=4096, vocab_size=51865,
    head_dim=64, norm="layernorm", mlp_act="gelu", use_rope=False,
    qkv_bias=False, encoder_seq=1500,
    source="arXiv:2212.04356",
)

"""pixtral-12b [vlm] — mistral-nemo decoder consuming stubbed ViT patch
embeddings (input_specs provides them). [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.config import ModelConfig

MODEL = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, num_heads=32, num_kv_heads=8,
    d_ff=14336, vocab_size=131072, head_dim=128, num_patches=1024,
    rope_theta=1000000000.0,
    source="hf:mistralai/Pixtral-12B-2409",
)

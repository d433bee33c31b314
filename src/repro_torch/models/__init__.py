"""The paper's classifier models in PyTorch."""

"""The paper's own FEMNIST experiment (§6.1): CNN, 64 devices, 8 edge
servers on a ring, tau=2, q=8, pi=10. [paper + LEAF arXiv:1812.01097]"""
from repro_torch.config import FLConfig

FL = FLConfig(algorithm="ce_fedavg", num_clusters=8, devices_per_cluster=8,
              tau=2, q=8, pi=10, topology="ring")
MODEL_NAME = "femnist_cnn"
NUM_CLASSES = 62
IMAGE = (28, 28, 1)
PARAMS = 6_603_710

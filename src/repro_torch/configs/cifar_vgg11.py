"""The paper's own CIFAR-10 experiment (§6.1): modified VGG-11, 64 devices,
8 edge servers on a ring, Dirichlet(0.5) non-IID. [paper §6.1]"""
from repro_torch.config import FLConfig

FL = FLConfig(algorithm="ce_fedavg", num_clusters=8, devices_per_cluster=8,
              tau=2, q=8, pi=10, topology="ring")
MODEL_NAME = "vgg11"
NUM_CLASSES = 10
IMAGE = (32, 32, 3)
PARAMS = 9_750_922

"""The paper's own validation network (ResNet-type, 21 conv layers,
CIFAR-10). The measured FPGA board configurations of the JAX package's
module arrive with the accelerator-model slice of the port."""
from ..models.cnn import ResNetConfig

CONFIG = ResNetConfig()                       # fp32
CONFIG_INT8 = ResNetConfig(quantized=True)    # Q2.5 / Q3.4 QAT

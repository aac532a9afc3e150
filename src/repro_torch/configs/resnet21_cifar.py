"""The paper's own validation network (ResNet-type, 21 conv layers,
CIFAR-10) + the measured board configurations."""
from ..accel.config import BOARDS, ZEDBOARD_100, ZEDBOARD_83_144, ZYBO_70
from ..models.cnn import ResNetConfig

CONFIG = ResNetConfig()                       # fp32
CONFIG_INT8 = ResNetConfig(quantized=True)    # Q2.5 / Q3.4 QAT

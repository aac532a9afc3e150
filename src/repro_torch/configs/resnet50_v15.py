"""ResNet-50 v1.5 at its published sizes (He et al., arXiv:1512.03385,
Table 1's 50-layer column; the stride on each bottleneck's 3×3 conv, as
torchvision's ``resnet50``): 53 convs, 25 557 032 parameters, 4.09 G
multiply-adds a 224×224×3 frame. The image-classification model of MLPerf
Inference."""
from ..models.cnn import ResNetConfig

CONFIG = ResNetConfig(block="bottleneck", stem="imagenet", stages=(3, 4, 6, 3),
                      widths=(64, 128, 256, 512), num_classes=1000, in_channels=3,
                      image_size=224)

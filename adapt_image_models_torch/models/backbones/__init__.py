from adapt_image_models_torch.models.backbones.aim import AIM  # noqa: F401
from adapt_image_models_torch.models.backbones.flash_variants import (  # noqa: F401
    AIM_FLASH, AIM_FLASH_WIN,
)
from adapt_image_models_torch.models.backbones.restuning import (  # noqa: F401
    ViT_CLIP_FLASH_RES_TUNING, ViT_CLIP_RES_TUNING,
)
from adapt_image_models_torch.models.backbones.resnet import (  # noqa: F401
    ResNet, ResNetTSM, ResNeXt,
)
from adapt_image_models_torch.models.backbones.densenet import DenseNet  # noqa: F401
from adapt_image_models_torch.models.backbones.mobilenet import (  # noqa: F401
    MobileNetV2, MobileNetV2TSM, ResNet2Plus1d, TANet,
)
from adapt_image_models_torch.models.backbones.resnet3d import (  # noqa: F401
    C3D, NonLocal3d, ResNet3d, ResNet3dCSN, ResNet3dLayer, ResNet3dSlowOnly, ResNetAudio,
)
from adapt_image_models_torch.models.backbones.resnet_tin import ResNetTIN  # noqa: F401
from adapt_image_models_torch.models.backbones.slowfast import X3D, ResNet3dSlowFast  # noqa: F401
from adapt_image_models_torch.models.backbones.swin2d_adapter import (  # noqa: F401
    SwinTransformer2D_Adapter,
)
from adapt_image_models_torch.models.backbones.swin3d import (  # noqa: F401
    SwinTransformer2D, SwinTransformer3D,
)
from adapt_image_models_torch.models.backbones.timesformer import TimeSformer  # noqa: F401
from adapt_image_models_torch.models.backbones.vit_clip import (  # noqa: F401
    ViT_CLIP, ViT_CLIP_FLASH,
)
from adapt_image_models_torch.models.backbones.vit_imagenet import ViT_ImageNet  # noqa: F401
from adapt_image_models_torch.models.backbones.zeroi2v import ViT_CLIP_ZEROI2V  # noqa: F401

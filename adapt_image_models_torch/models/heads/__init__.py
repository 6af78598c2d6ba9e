from adapt_image_models_torch.models.heads.acrn_head import ACRNHead  # noqa: F401
from adapt_image_models_torch.models.heads.bbox_head import BBoxHeadAVA  # noqa: F401
from adapt_image_models_torch.models.heads.fbo_head import (  # noqa: F401
    FBOAvg, FBOHead, FBOMax, FBONonLocal, LFBInferHead, NonLocalLayer,
)
from adapt_image_models_torch.models.heads.i3d_head import I3DHead  # noqa: F401
from adapt_image_models_torch.models.heads.misc_heads import (  # noqa: F401
    SlowFastHead, TimeSformerHead, TPNHead, TSMHead, X3DHead,
)
from adapt_image_models_torch.models.heads.ssn_head import SSNHead  # noqa: F401
from adapt_image_models_torch.models.heads.trn_head import TRNHead  # noqa: F401
from adapt_image_models_torch.models.heads.tsn_head import TSNHead  # noqa: F401

"""KeypointFusion RGB-D stack on tensors (port of hamer_yolo_tpu/models/kpfusion_rgbd/).

- resunet.py      OfficialResNetUnet (depth and RGB streams)
- geometry.py     normalized uvd <-> xyz, offset maps, the pcl index, the GAM
- bert.py         TR_Encoder / KP_Interaction_TR
- transfusion.py  TransformerDecoderLayer and the detr / updated / spatial decoders
- desa.py         DESA multi-scale grouping (ops/pointnet.py)
- model.py        Block_KPFusion and the 2-stage KPFusion
- runtime.py      Model_RGBD's host pre- and post-processing around the forward
- centernet.py    the centerNet regression head
- layers.py       CBAM / RGBDFusion / hourglass PoseNet
- mano_head.py    mano_regHead, the MANO-parameter head
"""
from hamer_yolo_tpu_torch.models.kpfusion_rgbd.model import (  # noqa: F401
    KPFusionConfig, init_kpfusion, kpfusion_forward,
)

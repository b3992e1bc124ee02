from hamer_yolo_tpu_torch.geometry.rotations import (
    aa_to_rotmat,
    quat_to_rotmat,
    rot6d_to_rotmat,
    rotmat_to_aa,
    rotmat_to_quat,
    rotmat_orthonormalize,
)
from hamer_yolo_tpu_torch.geometry.camera import (
    perspective_projection,
    project_with_intrinsics,
    cam_to_translation,
    cam_crop_to_full,
    custom_cam_crop_to_full,
    uvd2xyz,
    xyz2uvd,
    calculate_k_value,
)
from hamer_yolo_tpu_torch.geometry.boxes import (
    xyxy2xywh,
    xywh2xyxy,
    box_iou,
    box_area,
    clip_boxes,
    scale_coords,
    expand_to_aspect_ratio,
    hamer_box_params,
    sanitize_bbox_xywh,
    process_bbox,
)
from hamer_yolo_tpu_torch.geometry.affine import (
    gen_trans_from_patch,
    invert_affine,
    bilinear_sample,
    warp_affine,
    crop_resize_normalize,
    letterbox_params,
    letterbox_image,
    letterbox_numpy,
)
from hamer_yolo_tpu_torch.geometry.flip import (
    flip_correction_factor,
    correct_pred_cam,
    flip_keypoints3d,
    mirror_mesh,
    rewind_faces,
)

__all__ = [k for k in dir() if not k.startswith("_")]

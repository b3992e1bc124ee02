"""HaMeR's adversarial MANO pose and shape critic (port of
hamer_yolo_tpu/models/discriminator.py): a shared 9 -> 32 -> 32 embedding of
each of the 15 joint rotation matrices, one linear critic per joint, a
betas critic (10 -> 10 -> 5 -> 1) and a full-pose critic over the 15
embeddings (480 -> 1024 -> 1024 -> 1); (B, 17) logits, in JAX's order of
operations."""
from __future__ import annotations

import torch

from hamer_yolo_tpu_torch.core import nn

NUM_JOINTS = 15
EMBED = 32


def init_discriminator(gen: torch.Generator) -> nn.Params:
    """Seeded random parameters on ``gen``'s device (the JAX initialisers'
    distributions, not their numbers)."""
    return {
        "conv1": nn.linear_init(gen, 9, EMBED),
        "conv2": nn.linear_init(gen, EMBED, EMBED),
        "joint_out": [nn.linear_init(gen, EMBED, 1) for _ in range(NUM_JOINTS)],
        "shape_fc1": nn.linear_init(gen, 10, 10),
        "shape_fc2": nn.linear_init(gen, 10, 5),
        "shape_out": nn.linear_init(gen, 5, 1),
        "pose_fc1": nn.linear_init(gen, EMBED * NUM_JOINTS, 1024),
        "pose_fc2": nn.linear_init(gen, 1024, 1024),
        "pose_out": nn.linear_init(gen, 1024, 1),
    }


def discriminator_forward(params: nn.Params, hand_pose: torch.Tensor,
                          betas: torch.Tensor) -> torch.Tensor:
    """hand_pose (B, 15, 3, 3) rotation matrices, betas (B, 10) -> (B, 17)
    logits: the 15 joints', the shape critic's, the full pose's."""
    B = hand_pose.shape[0]
    e = torch.relu(nn.linear(params["conv1"], hand_pose.reshape(B, NUM_JOINTS, 9)))
    e = torch.relu(nn.linear(params["conv2"], e))                        # (B, 15, EMBED)
    joint_logits = torch.cat([nn.linear(params["joint_out"][j], e[:, j])
                              for j in range(NUM_JOINTS)], dim=-1)       # (B, 15)
    s = torch.relu(nn.linear(params["shape_fc1"], betas))
    s = torch.relu(nn.linear(params["shape_fc2"], s))
    shape_logit = nn.linear(params["shape_out"], s)                     # (B, 1)
    p = torch.relu(nn.linear(params["pose_fc1"], e.reshape(B, -1)))
    p = torch.relu(nn.linear(params["pose_fc2"], p))
    pose_logit = nn.linear(params["pose_out"], p)                       # (B, 1)
    return torch.cat([joint_logits, shape_logit, pose_logit], dim=-1)

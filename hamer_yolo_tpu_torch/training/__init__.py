"""Training: losses, optimizers and train steps (port of hamer_yolo_tpu/training/)."""

"""PyTorch + CUDA port of orb_slam2_with_comment_tpu (RGB-D tracking slice)."""

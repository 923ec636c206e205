"""The dataset drivers of the PyTorch port (the reference's Examples/
drivers), one module each:

    python -m orb_slam2_with_comment_tpu_torch.examples.rgbd_tum \\
        settings.yaml SEQ_DIR [associations.txt] [--auto] [--device cpu]

``rgbd_tum``, ``stereo_kitti``, ``stereo_euroc``, ``mono_tum``,
``mono_kitti`` and ``mono_euroc`` take the JAX package's drivers'
arguments, print the same summary lines and write the same files in the
working directory (CameraTrajectory.txt, KeyFrameTrajectory.txt,
run_summary.json). ``--device`` names the torch device (default
``cuda``). Each exposes ``main(argv)``; nothing runs at import.
"""

"""PyTorch / CUDA port of the multimodal 3D detector for NVIDIA Hopper.

A second package beside ``bevfusion_multimodal_3d_object_detection_tpu``
(the JAX reference), with the same module names. It imports torch and
numpy, never JAX or the JAX package.
"""

"""PyTorch/CUDA port of flickering_adversarial_video_tpu for NVIDIA Hopper.

The universal flickering attack on I3D: attack math (attack/), the stem
packing, input head, conv units and pools with their hand-written CUDA
kernels (ops/, csrc/), InceptionI3D (models/), the Flax weight bridge
(convert/), the attack engine (engine/) and data parallelism over
torch.distributed ranks (parallel/).  Imports torch, never jax.
"""

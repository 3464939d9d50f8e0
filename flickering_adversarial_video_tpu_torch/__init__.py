"""PyTorch/CUDA port of flickering_adversarial_video_tpu for NVIDIA Hopper.

The universal flickering attack on I3D: attack math (attack/), the stem
packing, input head, conv units and pools with their hand-written CUDA
kernels (ops/, csrc/), InceptionI3D (models/), the Flax weight bridge
(convert/) and the attack engine (engine/).  Imports torch, never jax.
"""

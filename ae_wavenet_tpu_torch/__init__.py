"""ae_wavenet_tpu_torch: the WaveNet autoencoder and the MFCC inverter in
PyTorch (training, serving, evaluation, preprocessing), with CUDA kernels
written by hand for Hopper for the fused gated stack, the autoregressive
sampler and the VQ lookup.

The JAX package ``ae_wavenet_tpu`` beside it is the reference this port is
tested against; the port imports nothing from it.
"""

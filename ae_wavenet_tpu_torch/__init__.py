"""ae_wavenet_tpu_torch: the WaveNet autoencoder's serving path in PyTorch,
with a CUDA kernel written by hand for Hopper for the autoregressive sampler.

The JAX package ``ae_wavenet_tpu`` beside it is the reference this port is
tested against; the port imports nothing from it.
"""

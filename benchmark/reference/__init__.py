"""The plain reference that decides a run's ``correct``.

Plain PyTorch in float32 (TF32 off on the card), frozen here so that no
later change to the program moves it.  ``config``, ``vconv``, ``mfcc``,
``mulaw`` and ``conv1d`` are copies of the port's plain modules of the same
names; ``models`` restates the autoencoder and the MFCC inverter along the
published description (MFCC frontend, Chorowski encoder, VQ-EMA bottleneck
with jitter, the latent-to-frame aux head, the transposed-conv upsampler,
the dilated gated WaveNet, post-net and mu-law cross-entropy); ``train``
follows the first training steps with plain Adam, a batch row at a time;
``models.teacher_logits`` gives the teacher-forced logits of served
tokens and ``sampling`` the sampler's draws beside them; ``data``
re-derives the training windows, the steps' draws and the frame statistics
from the raw packed file.  Nothing here imports the program, ``jax`` or the
JAX package, and nothing takes a tensor the program made.

Every product the program computes in bf16 goes through ``q``
(``precision.exact`` for the reference); ``precision.fp8`` computes it in
fp8, the precision below the configuration's bf16, which makes the control.
"""

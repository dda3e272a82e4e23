"""PyTorch/CUDA port of the WaveGlow vocoder in ``waveglow_tpu``.

Serves mel -> waveform synthesis on an NVIDIA H100. The one TPU kernel of
the JAX package (the fused WN layer) is a hand-written CUDA kernel here
(``kernels/wn_layer.py`` + ``csrc/wn_layer.cu``); the rest is plain torch.
Parameters keep the JAX package's layout, so one npz checkpoint feeds both.
"""

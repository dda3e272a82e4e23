"""PyTorch/CUDA port of the WaveGlow vocoder in ``waveglow_tpu``.

Serves mel -> waveform synthesis and trains the model on an NVIDIA H100.
The one TPU kernel of the JAX package (the fused WN layer) is a hand-written
CUDA kernel here (``kernels/wn_layer.py`` + ``csrc/wn_layer.cu``), wrapped
in an autograd Function for training; the rest is plain torch.
Parameters keep the JAX package's layout, so one npz checkpoint feeds both;
the reference's torch ``.pt`` files import (``checkpointing/import_torch``).
The command line is ``python -m waveglow_tpu_torch`` (``waveglow-tpu-torch``).
"""

__version__ = "0.5.0"

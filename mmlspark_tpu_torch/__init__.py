"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

A second package beside the JAX reference, for one NVIDIA H100. This
slice carries paged decode serving with the prefix cache: the
transformer decode numerics (``models/transformer.py``), the decoder and
its continuous-batching scheduler (``serving/decode.py``), and three
hand-written Hopper attention kernels (``csrc/``, bound in
``parallel/cuda_attention.py``). Entry points run on the card unless
the caller passes ``device="cpu"``.
"""

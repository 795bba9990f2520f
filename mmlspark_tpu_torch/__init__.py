"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

A second package beside the JAX reference, for one NVIDIA H100. It
carries paged decode serving with the prefix cache and speculative
decoding: the transformer decode numerics (``models/transformer.py``),
the decoder and its continuous-batching scheduler
(``serving/decode.py``, ``serving/policy.py``), three hand-written
Hopper attention kernels (``csrc/``, bound in
``parallel/cuda_attention.py``) and the fused softmax cross-entropy
forward that scores the draft's proposals (``ops/fused_ce.py``).
Entry points run on the card unless the caller passes
``device="cpu"``.
"""

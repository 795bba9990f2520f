"""mmlspark_tpu_torch — the PyTorch/CUDA port of ``mmlspark_tpu``.

A second package beside the JAX reference, for one NVIDIA H100. It
carries paged decode serving with the prefix cache and speculative
decoding, and the transformer LM's single-device train step: the
transformer numerics (``models/transformer.py``), the decoder and its
continuous-batching scheduler (``serving/decode.py``,
``serving/policy.py``), hand-written Hopper attention kernels for
decode and for training (``csrc/``, bound in
``parallel/cuda_attention.py``) and the fused softmax cross-entropy
forward and backward (``ops/fused_ce.py``), and single-device GBDT
training and prediction (``gbdt/``) with a hand-written histogram
kernel. The decode scheduler reports through the JAX package's
observability plane, ported into ``core/`` (telemetry, tracing, the
metrics TSDB, the sampling and device profilers). Entry points run on
the card unless the caller passes ``device="cpu"``.
"""

"""PyTorch / CUDA port of the LASP-2 reproduction (``repro``).

The package mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``obs``, ``serve``, ``launch``) and is held against it by the
``tests/test_torch_*.py`` parity tests. It imports ``torch`` and numpy only:
never JAX, and nothing of ``repro``.

Entry points (``init_params``, ``ServeEngine``, ``launch/serve.py``) run on
the CUDA card unless the caller passes ``device="cpu"``. On CPU tensors the
kernel wrappers take their plain PyTorch versions; on CUDA tensors they
launch the hand-written Hopper kernels under ``kernels/csrc``.
"""

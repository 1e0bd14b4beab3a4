"""PyTorch port of the ``repro`` package, for an NVIDIA H100.

The JAX package ``repro`` is the reference; every module here mirrors its
counterpart there (``configs/``, ``core/``, ``data/``, ``models/``,
``optim/``, ``parallel/``, ``train/``, ``serve/``, ``launch/``,
``kernels/``) and is held to it by
``tests/test_torch_*.py``. This package imports torch and
numpy only: never ``jax`` and never ``repro``.

Entry points take ``device=None``, which means ``"cuda"``; they raise when
no card is present unless the caller asks for ``"cpu"``
(``repro_torch.device.resolve_device``). The dry run
(``launch/dryrun.py``) takes no device: it traces on ``"meta"``.
"""

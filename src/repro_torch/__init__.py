"""PyTorch/CUDA port of the speculative-decoding system in ``repro``.

The package mirrors ``repro``'s layout module for module, so each
function's counterpart has the same path and name.  It imports ``torch``
and never ``jax`` or anything of ``repro``: what it needs from there it
keeps as its own copy (``configs/``, ``core/tree.py``).

Entry points run on the card (``device="cuda"``) unless the caller asks for
``device="cpu"``, where every kernel wrapper takes its plain PyTorch
version; see ``runtime.resolve_device``.
"""

"""PyTorch/CUDA port of the ``repro`` package, for one NVIDIA Hopper card.

Same sub-packages and module names as ``src/repro`` so that the counterpart
of a module is found by path.  The port imports ``torch`` and numpy only;
every entry point runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""

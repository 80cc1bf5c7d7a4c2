"""Multi-device execution: data-parallel training over torch.distributed
(distributed.py, mesh.py) and height-split inference (mesh.py)."""

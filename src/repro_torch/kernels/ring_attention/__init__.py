"""Ring attention: the ring-step kernel (``kernel.py``, CUDA), its plain
twin (``ref.py``) and the fused ring over a Cartesian communicator
(``ops.py``)."""

"""The plain reference: a frozen copy of the port's models, agent tick and
distillation step with every CUDA kernel replaced by the port's plain
PyTorch form (the crops as gathers, the canvas and the decoration as
`scatter_reduce` / `index_add`, the int8 conv as an f32 conv of the
integers, autograd in place of the hand-written backward kernels), one
process holding the whole batch.  It imports nothing of the port and
nothing of JAX; `record` notes its crops and int8 convs for the op and
byte counts, and `nn/quant.py`'s QMAX sets the control's precision.
"""

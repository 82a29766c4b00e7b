"""The parallel layers of the port: the Switch-MoE FFN over the data axis
(``moe.py``).  Tensor, sequence, pipeline and expert parallelism are not
ported yet."""

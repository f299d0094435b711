"""The slab-decomposed force over several ranks of torch.distributed
(port of the slab part of fastpm_tpu/parallel/)."""

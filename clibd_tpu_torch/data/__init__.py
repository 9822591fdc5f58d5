"""Input data for the port.

`pipeline.py` (the HDF5 loader), `hdf5.py`, `tokenizers.py`, `transforms.py`,
`native.py` and `clip_tokenizer.py` are copies of the JAX package's jax-free
modules of the same names; h5py is imported only where a file is opened.
`SyntheticSplit` needs no file and feeds `extract_split` and the trainer from
memory.
"""

from .synthetic import SyntheticSplit

__all__ = ["SyntheticSplit"]

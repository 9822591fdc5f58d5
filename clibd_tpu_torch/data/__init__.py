"""Input data for the port.

`pipeline.py` (the HDF5 loader), `hdf5.py`, `tokenizers.py`, `transforms.py`,
`native.py`, `clip_tokenizer.py` and `insect.py` are copies of the JAX
package's jax-free modules of the same names; h5py is imported only where a
file is opened.  The dataset tools behind the data commands are copies too:
`splits.py` (split creation, split CSVs), `builders.py` and `builders_5m.py`
(the split HDF5 builders, serial and parallel with resume), `subset.py`,
`bins.py` and `ncbi.py` (the NCBI taxonomy fetch); they need h5py or pandas
at import and run on the host only.
`SyntheticSplit` needs no file and feeds `extract_split` and the trainer from
memory.
"""

from .synthetic import SyntheticSplit

__all__ = ["SyntheticSplit"]

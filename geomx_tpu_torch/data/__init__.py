from geomx_tpu_torch.data.synthetic import (  # noqa: F401
    ShardedIterator, TokenIterator, synthetic_classification, synthetic_lm)
from geomx_tpu_torch.data.recordio import (  # noqa: F401
    RecordReader, RecordWriter, pack_array, unpack_array,
    write_array_dataset,
)
from geomx_tpu_torch.data.iterators import (  # noqa: F401
    AugmentIter, CSVIter, LibSVMIter, MNISTIter, PrefetchIter,
    RecordDatasetIter,
)

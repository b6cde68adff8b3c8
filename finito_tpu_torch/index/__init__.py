from finito_tpu_torch.index.packed_strings import PackedStrings, permute_unitigs
from finito_tpu_torch.index.builder import FinimizerIndexBuilder
from finito_tpu_torch.index.index import FinimizerIndex, QueryResult

from finito_tpu_torch.io.sdsl import (
    save_int_vector,
    load_int_vector,
    save_bit_vector,
    load_bit_vector,
    IntVector,
)
from finito_tpu_torch.io.fastx import (
    SequenceReader,
    SequenceWriter,
    read_all_records,
    reverse_complement,
    figure_out_file_format,
)
from finito_tpu_torch.io.seqdb import SeqDB

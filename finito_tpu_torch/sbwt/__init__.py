from finito_tpu_torch.sbwt.sbwt import PlainMatrixSBWT
from finito_tpu_torch.sbwt.construct import build_plain_matrix_sbwt
from finito_tpu_torch.sbwt.lcs import lcs_array

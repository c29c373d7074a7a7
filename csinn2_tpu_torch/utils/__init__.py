from csinn2_tpu_torch.utils.logging import debug, error, get_level, info, set_level, warning
from csinn2_tpu_torch.utils.verify import VerifyResult, verify

"""AMP (counterpart of ``paddle_tpu/amp``): ``auto_cast`` with the
reference's white and black lists, ``decorate`` and ``GradScaler``."""
from .auto_cast import (amp_guard, amp_state, auto_cast, black_list,
                        decorate, white_list)
from .grad_scaler import AmpScaler, GradScaler

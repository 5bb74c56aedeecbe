"""Checkpoints of parameter trees, raw and quantized (port of
``repro.checkpoint``)."""
from repro_torch.checkpoint.checkpoint import (AsyncCheckpointer, keep_last,
                                               latest_step,
                                               quantized_template, restore,
                                               restore_quantized,
                                               restored_plan, save,
                                               save_quantized)

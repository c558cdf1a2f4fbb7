"""Loop ``stream``: one stream, closed loop, through `stream_eval`
(`loops.stream`), in the eval mode (`modes/eval.py`)."""
from portbench import loops
from portbench.modes import eval as eval_mode

FAULTS = eval_mode.FAULTS
run = eval_mode.mode(loops.stream)

"""main_vm: the EraVM circuit (the JAX package's `models/vm/`).

`native_sim.py` is the witness oracle (host: numpy and the native C++ cycle
loop), `circuit.py` re-derives every cycle transition row-parallel on the
device, `state.py` holds the host-side context records and their encoding.
The Python oracle (`sim.py`: `EraVM`, `simulate`) and the instance slicing
(`compact.py`) of the JAX package are not ported yet.
"""

from .state import (  # noqa: F401
    ExecutionContextRecord,
    encode_context_records_np,
    initial_bootloader_state,
)
from .native_sim import NativeEraVM, assemble_code_words  # noqa: F401
from .circuit import (  # noqa: F401
    all_ok,
    eval_constraints,
    eval_constraints_jit,
    prepare_device_witness,
)

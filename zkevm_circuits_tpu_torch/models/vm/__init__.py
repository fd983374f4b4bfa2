"""main_vm: the EraVM circuit (the JAX package's `models/vm/`).

`sim.py` is the Python witness oracle and tracer (host, numpy),
`native_sim.py` the same oracle through the native C++ cycle loop,
`circuit.py` re-derives every cycle transition row-parallel on the device,
`compact.py` slices a long run into `limit`-cycle ClosedFormInput instances,
`state.py` holds the host-side context records and their encoding;
`compact.vm_eval_instances_sharded` evaluates the instances over a mesh.
"""

from .state import (  # noqa: F401
    ExecutionContextRecord,
    encode_context_records_np,
    initial_bootloader_state,
)
from .sim import EraVM, VmConfig, assemble_code_words, simulate  # noqa: F401
from .native_sim import NativeEraVM  # noqa: F401
from .circuit import (  # noqa: F401
    all_ok,
    eval_constraints,
    eval_constraints_jit,
    prepare_device_witness,
)
from .compact import (  # noqa: F401
    boot_and_exit_residuals,
    encode_local_state,
    vm_eval_instances_sharded,
    vm_instance_compact_forms,
    vm_instance_windows,
)

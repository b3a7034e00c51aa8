from repro_torch.optim.local import make_optimizer  # noqa: F401
from repro_torch.optim.fedopt import make_server_optimizer  # noqa: F401

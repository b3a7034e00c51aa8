from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    Checkpointer, load_manifest, restore_state, save_state)

from .manager import (CheckpointManager, load_tree, restore_resharded,
                      save_tree)

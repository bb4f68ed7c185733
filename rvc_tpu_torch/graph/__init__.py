"""ComfyUI entry point of the port: the node registry under the JAX
package's keys (``RVC_TPU_*``), so a saved workflow runs unchanged, and the
repository's ``web/`` widgets, the MuseTalk lip-sync nodes among them.
Load this package or ``rvc_tpu.graph`` into one ComfyUI, not both: the
keys are the same."""
import os

from .musetalk_nodes import MUSETALK_NODE_CLASS_MAPPINGS
from .nodes import NODE_CLASS_MAPPINGS as _RVC_NODES
from .stt_nodes import STT_NODE_CLASS_MAPPINGS
from .utility_nodes import UTILITY_NODE_CLASS_MAPPINGS

NODE_CLASS_MAPPINGS = {**_RVC_NODES, **UTILITY_NODE_CLASS_MAPPINGS, **STT_NODE_CLASS_MAPPINGS,
                       **MUSETALK_NODE_CLASS_MAPPINGS}
NODE_DISPLAY_NAME_MAPPINGS = {
    k: k.replace("RVC_TPU_", "RVC-TPU ") for k in NODE_CLASS_MAPPINGS
}

# ComfyUI joins this to the extension's folder; an absolute path is kept as is
WEB_DIRECTORY = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "web")

__all__ = ["NODE_CLASS_MAPPINGS", "NODE_DISPLAY_NAME_MAPPINGS", "WEB_DIRECTORY"]

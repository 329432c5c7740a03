from repro_torch.fem.mesh import HexMesh, beam_hex
from repro_torch.fem.space import H1Space

__all__ = ["HexMesh", "beam_hex", "H1Space"]

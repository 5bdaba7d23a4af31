"""ArcticNet-SF (``arctic_sf_light``): the WildHands architecture under
another method name (port of ``hands_tpu/models/arctic_light.py``).

The reference defines it as a subclass that changes nothing; the difference
lives in the method's config (``config.py``: no KPE, no crops, so one
global-image backbone feeds both hands' heads, with the grasp classifier
and the silhouette render on).
"""

from __future__ import annotations

from hands_tpu_torch.config import Config
from hands_tpu_torch.models.hands_light import HandsLightModel


class ArcticSFLightModel(HandsLightModel):
    def __init__(self, cfg: Config, device=None):
        super().__init__(cfg, device=device)

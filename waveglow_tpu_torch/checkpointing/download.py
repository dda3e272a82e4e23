"""Download NVIDIA's pretrained WaveGlow checkpoints (counterpart of
``waveglow_tpu/checkpointing/download.py``; standard library only).

v2/v3/v5 come from the NGC API, v1 from Google Drive through its "large
file" confirm flow: fetch with a cookie jar, take the confirm token from
the warning cookie or the download form, and request again. The body
streams to ``<name>.part`` and is renamed into place when complete; every
socket operation times out after 60 s.
"""

from __future__ import annotations

import http.cookiejar
import os
import logging
import re
import shutil
import urllib.parse
import urllib.request
from pathlib import Path
from typing import Optional, Tuple

logger = logging.getLogger(__name__)

_NGC_URLS = {
    2: ("https://api.ngc.nvidia.com/v2/models/nvidia/waveglow_ljs_256channels"
        "/versions/2/files/waveglow_256channels_ljs_v2.pt"),
    3: ("https://api.ngc.nvidia.com/v2/models/nvidia/waveglow_ljs_256channels"
        "/versions/3/files/waveglow_256channels_ljs_v3.pt"),
    5: ("https://api.ngc.nvidia.com/v2/models/nvidia/adlr/waveglow/versions"
        "/WaveGlow-LJS_256_Channels/files"
        "/waveglow_256channels_universal_v5.pt"),
}
_GDRIVE_V1 = "https://drive.google.com/uc?id=1rpK8CzAAirq9sWZhe9nlfvxMF1dRgFbF"


# per-socket-op timeout: urllib's default (None) hangs forever on a stalled
# connection — a dead NGC/Drive transfer should fail and be retryable
_TIMEOUT_S = 60.0


def _save_stream(response, destination: Path) -> None:
  """Stream the body to a temp file, then atomically rename: a dropped
  connection mid-transfer must not leave a truncated checkpoint at the
  destination (the torch loader would later fail far from the cause)."""
  destination = Path(destination)
  tmp = destination.with_name(destination.name + ".part")
  try:
    with open(tmp, "wb") as out:
      shutil.copyfileobj(response, out, length=1 << 20)
    os.replace(tmp, destination)
  finally:
    if tmp.exists():
      tmp.unlink()


def parse_gdrive_interstitial(html: str) -> Optional[Tuple[str, dict]]:
  """Extract (form action URL, hidden form fields) from Google Drive's
  "can't scan this file for viruses" interstitial page.

  Returns None if the page carries no download form. Covers both the
  legacy ``confirm=<token>`` link and the current
  ``drive.usercontent.google.com`` form with hidden inputs.
  """
  form = re.search(r'<form[^>]+action="([^"]+)"[^>]*>(.*?)</form>', html,
                   re.DOTALL)
  if form:
    # The action may be HTML-escaped, relative, and/or already carry a
    # query string; normalize all three so the caller can append fields.
    action = form.group(1).replace("&amp;", "&")
    body = form.group(2)
    fields = dict(re.findall(
        r'<input[^>]+name="([^"]+)"[^>]+value="([^"]*)"', body))
    if fields:
      return action, fields
  legacy = re.search(r'href="(/uc\?[^"]*confirm=[^"]+)"', html)
  if legacy:
    url = "https://drive.google.com" + legacy.group(1).replace("&amp;", "&")
    return url, {}
  return None


def _download_gdrive(url: str, destination: Path) -> None:
  """Google Drive download with the large-file confirm-token flow."""
  cookies = http.cookiejar.CookieJar()
  opener = urllib.request.build_opener(
      urllib.request.HTTPCookieProcessor(cookies))
  opener.addheaders = [("User-Agent", "waveglow-tpu-torch")]

  with opener.open(url, timeout=_TIMEOUT_S) as response:
    content_type = response.headers.get("Content-Type", "")
    if "text/html" not in content_type:
      _save_stream(response, destination)
      return
    html = response.read().decode("utf-8", errors="replace")

  # large file: confirm token lives in a warning cookie or the form page
  token = next((c.value for c in cookies
                if c.name.startswith("download_warning")), None)
  if token:
    sep = "&" if "?" in url else "?"
    confirmed, fields = f"{url}{sep}confirm={token}", None
  else:
    parsed = parse_gdrive_interstitial(html)
    if parsed is None:
      raise RuntimeError(
          "Google Drive returned an HTML page with no download form — the "
          "file may be removed or quota-limited; try again later or fetch "
          "v2/v3/v5 from NGC instead.")
    confirmed, fields = parsed
    # absolutize a relative form action against the page we fetched
    confirmed = urllib.parse.urljoin(url, confirmed)
    if fields:
      sep = "&" if "?" in confirmed else "?"
      confirmed = confirmed + sep + urllib.parse.urlencode(fields)

  with opener.open(confirmed, timeout=_TIMEOUT_S) as response:
    if "text/html" in response.headers.get("Content-Type", ""):
      raise RuntimeError("Google Drive confirm flow failed (still HTML)")
    _save_stream(response, destination)


def download_pretrained_model(destination: Path, version: int = 3) -> None:
  """Fetch the pretrained checkpoint (~644 MB) to ``destination``."""
  destination = Path(destination)
  destination.parent.mkdir(parents=True, exist_ok=True)
  logger.info("Downloading pretrained waveglow model v%d from Nvidia...",
              version)
  if version in _NGC_URLS:
    request = urllib.request.Request(
        _NGC_URLS[version], headers={"User-Agent": "waveglow-tpu-torch"})
    with urllib.request.urlopen(request,
                                timeout=_TIMEOUT_S) as response:
      _save_stream(response, destination)
  elif version == 1:
    _download_gdrive(_GDRIVE_V1, destination)
  else:
    raise ValueError(f"unsupported pretrained version {version}; "
                     f"choose from 1, 2, 3, 5")
  logger.info("Done: %s (%.1f MB)", destination,
              destination.stat().st_size / 1e6)

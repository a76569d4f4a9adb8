"""Bird recordings from xeno-canto (counterpart of the repository's
`scripts/utils/xeno_canto_dl.py`), through the public API with `urllib`.
Needs the network.

    python -m vampnet_tpu_torch.scripts.utils.xeno_canto_dl --output_dir data/birds \
        --max_per_species 10
"""
from __future__ import annotations

import json
import urllib.parse
import urllib.request
from pathlib import Path

from ... import config as cfglib

SPECIES = [
    "American Robin", "Northern Cardinal", "Mourning Dove", "American Crow",
    "Baltimore Oriole", "Blue Jay", "Eastern Bluebird", "House Finch",
    "American Goldfinch", "House Sparrow", "Song Sparrow", "Tufted Titmouse",
    "White-breasted Nuthatch", "European Starling", "American Redstart",
    "Red-winged Blackbird", "Brown-headed Cowbird", "Common Grackle",
    "Common Yellowthroat", "Northern Mockingbird", "Carolina Wren",
    "Eastern Meadowlark", "Chipping Sparrow", "Tree Swallow", "Barn Swallow",
]

API = "https://xeno-canto.org/api/2/recordings"


def download_species(name: str, output_dir: Path, max_recordings: int = 10,
                     quality: str = "A") -> int:
    """Up to `max_recordings` recordings of `name` at `quality` into
    `output_dir/<name>/<id>.mp3`; files already there are kept. Returns the
    number downloaded."""
    query = urllib.parse.quote(f"{name} q:{quality}")
    with urllib.request.urlopen(f"{API}?query={query}") as r:
        data = json.loads(r.read())
    out = output_dir / name.replace(" ", "_")
    out.mkdir(parents=True, exist_ok=True)
    n = 0
    for rec in data.get("recordings", [])[:max_recordings]:
        url = rec["file"]
        if url.startswith("//"):
            url = "https:" + url
        dest = out / f"{rec['id']}.mp3"
        if dest.exists():
            continue
        try:
            urllib.request.urlretrieve(url, dest)
            n += 1
        except OSError as e:  # urllib's URLError and HTTPError are OSErrors
            print(f"  failed {url}: {e}")
    print(f"{name}: downloaded {n} recordings")
    return n


def main(argv=None):
    args = cfglib.parse_args(argv)
    output_dir = Path(args.get("output_dir", "data/xeno-canto"))
    total = sum(download_species(sp, output_dir,
                                 max_recordings=int(args.get("max_per_species", 10)))
                for sp in SPECIES)
    print(f"downloaded {total} recordings to {output_dir}")
    return total


if __name__ == "__main__":
    main()

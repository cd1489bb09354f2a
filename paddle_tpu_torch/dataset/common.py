"""Legacy dataset helpers — port of ``paddle_tpu/dataset/common.py``
(reference: python/paddle/dataset/common.py).

The reference's download/md5 machinery is egress-bound; what survives here
is the reader-combinator surface its users actually compose with.
"""

from __future__ import annotations

DATA_HOME = None  # no download cache in the egress-free runtime


def cluster_files_reader(files_pattern, trainer_count, trainer_id):
    """Round-robin shard of sorted glob matches (common.py cluster_files_reader)."""
    import glob

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, path in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(path, "rb") as f:
                    yield f.read()

    return reader

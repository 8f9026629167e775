"""Raw-dataset preprocessing: names -> ids, timestamps -> indices.

Turns tab-separated name files (``head \t rel \t tail \t time``, times as
YYYY-MM-DD or integers) into the standard layout the training pipeline
reads, byte for byte as the JAX package's ``data/preprocess.py`` writes it:

    <out>/train.txt valid.txt test.txt   (h r t time, tab-separated ids)
    <out>/entity2id.txt relation2id.txt  (name \t id)
    <out>/stat.txt                       (num_ents num_rels num_times)

plus ``bucket_years``, the year classes of interval datasets (YAGO,
Wikidata). Run it as

    python -m temp_tpu_torch.data.preprocess --input-dir RAW --output-dir OUT
"""

from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict
from typing import Dict, List, Tuple


def read_named_quads(path: str) -> List[Tuple[str, str, str, int]]:
    """Parse `head \t rel \t tail \t time` with YYYY-MM-DD or integer
    times."""
    out = []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            if len(parts) < 4:
                continue
            head, rel, tail, time = parts[0], parts[1], parts[2], parts[3]
            time = int(re.sub(r"-", "", time))
            out.append((head, rel, tail, time))
    return out


def bucket_years(intervals: List[Tuple[int, int]], min_count: int = 300):
    """Year bucketing for interval datasets: group years so each class
    holds >= min_count facts."""
    freq = defaultdict(int)
    for start, end in intervals:
        if start >= 0:
            freq[start] += 1
        if end >= 0:
            freq[end] += 1
    years = sorted(freq)
    classes = []
    count, start_year = 0, None
    for y in years:
        if start_year is None:
            start_year = y
        count += freq[y]
        if count >= min_count:
            classes.append((start_year, y))
            start_year, count = None, 0
    if start_year is not None:
        classes.append((start_year, years[-1]))
    elif classes:
        last = classes[-1]
        classes[-1] = (last[0], years[-1])
    return classes


def year_to_class(classes, year: int) -> int:
    for i, (lo, hi) in enumerate(classes):
        if lo <= year <= hi:
            return i
    return len(classes) - 1


def preprocess_interpolation(input_dir: str, output_dir: str) -> Dict[str, int]:
    """Names -> contiguous ids, raw times -> contiguous time indices."""
    splits = {}
    entities, relations, times = set(), set(), set()
    for split in ("train", "valid", "test"):
        quads = read_named_quads(os.path.join(input_dir, f"{split}.txt"))
        splits[split] = quads
        for h, r, t, tm in quads:
            entities.update((h, t))
            relations.add(r)
            times.add(tm)

    ent2id = {e: i for i, e in enumerate(sorted(entities))}
    rel2id = {r: i for i, r in enumerate(sorted(relations))}
    time2idx = {t: i for i, t in enumerate(sorted(times))}

    os.makedirs(output_dir, exist_ok=True)
    for split, quads in splits.items():
        with open(os.path.join(output_dir, f"{split}.txt"), "w") as f:
            for h, r, t, tm in quads:
                f.write(f"{ent2id[h]}\t{rel2id[r]}\t{ent2id[t]}\t{time2idx[tm]}\n")
    with open(os.path.join(output_dir, "entity2id.txt"), "w") as f:
        for e, i in ent2id.items():
            f.write(f"{e}\t{i}\n")
    with open(os.path.join(output_dir, "relation2id.txt"), "w") as f:
        for r, i in rel2id.items():
            f.write(f"{r}\t{i}\n")
    with open(os.path.join(output_dir, "stat.txt"), "w") as f:
        f.write(f"{len(ent2id)}\t{len(rel2id)}\t{len(time2idx)}\n")
    return {"num_ents": len(ent2id), "num_rels": len(rel2id),
            "num_times": len(time2idx)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input-dir", required=True)
    ap.add_argument("--output-dir", required=True)
    args = ap.parse_args()
    stats = preprocess_interpolation(args.input_dir, args.output_dir)
    print(stats)


if __name__ == "__main__":
    main()

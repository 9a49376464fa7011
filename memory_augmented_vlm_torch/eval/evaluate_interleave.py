"""Interleave-benchmark metrics (a copy of
`memory_augmented_vlm_tpu/eval/evaluate_interleave.py`, which has no
framework code) — capability parity with
llava/eval/evaluate_interleave.py: ROUGE-L for captioning-style tasks,
normalized multi-choice accuracy for QA-style tasks, grouped per benchmark
category (spot_the_diff, image_edit_instruct, visual_story_telling, ...,
puzzle, nlrv2, qbench).

ROUGE-L is computed with a dependency-free LCS implementation (the reference
uses the `rouge` pip package, not bundled here).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from collections import defaultdict
from typing import Dict, List, Sequence

CATEGORIES: Dict[str, List[str]] = {
    "spot_the_diff": ["Spot-the-Diff", "Birds-to-Words", "CLEVR-Change"],
    "image_edit_instruct": ["IEdit", "HQ-Edit", "MagicBrush"],
    "visual_story_telling": ["AESOP", "FlintstonesSV", "PororoSV", "VIST"],
    "visual_cloze": ["COMICS_Dialogue", "RecipeQA_VisualCloze"],
    "text_rich_vqa": ["WebQA", "TQA", "OCR-VQA", "DocVQA"],
    "multi_image_vqa": ["MIT-States_StateCoherence", "MIT-States_PropertyCoherence",
                        "VISION", "RecipeQA_ImageCoherence"],
    "puzzle": ["RAVEN"],
    "nlrv2": ["NLVR2_Mantis"],
    "qbench": ["QBench"],
}

_PUNCT = re.compile(r"[\.,!\?;:'\"\(\)\[\]\{\}]")
_ARTICLES = re.compile(r"\b(a|an|the)\b")


def normalize_answer(text: str) -> str:
    """Punctuation/article stripping (reference processPunctuation/process)."""
    text = text.lower().strip()
    text = _PUNCT.sub("", text)
    text = _ARTICLES.sub(" ", text)
    return " ".join(text.split())


def rouge_l_f(pred: str, ref: str) -> float:
    """ROUGE-L F1 via LCS over tokens."""
    p = normalize_answer(pred).split()
    r = normalize_answer(ref).split()
    if not p or not r:
        return 0.0
    dp = [[0] * (len(r) + 1) for _ in range(len(p) + 1)]
    for i in range(1, len(p) + 1):
        for j in range(1, len(r) + 1):
            dp[i][j] = (dp[i - 1][j - 1] + 1 if p[i - 1] == r[j - 1]
                        else max(dp[i - 1][j], dp[i][j - 1]))
    lcs = dp[-1][-1]
    prec, rec = lcs / len(p), lcs / len(r)
    return 0.0 if prec + rec == 0 else 2 * prec * rec / (prec + rec)


def judge_multi_choice(pred: str, answer: str, choices: Sequence[str]) -> bool:
    """Reference multi-choice matching: exact normalized answer, or the
    choice letter, or the unique choice whose text the prediction contains."""
    pred_n, ans_n = normalize_answer(pred), normalize_answer(answer)
    if pred_n == ans_n and pred_n:
        return True
    # choice-letter answers checked on the raw (un-normalized) prediction —
    # normalization strips the article "a", which is also a valid letter
    raw = pred.strip().lower().rstrip(".")
    letters = "abcdefgh"
    for i, c in enumerate(choices):
        if normalize_answer(c) == ans_n and raw == letters[i]:
            return True
    hits = [c for c in choices if normalize_answer(c) and normalize_answer(c) in pred_n]
    return len(hits) == 1 and normalize_answer(hits[0]) == ans_n


def evaluate(predictions: List[dict]) -> Dict[str, float]:
    """predictions: [{dataset, question_type, prediction/text, answer,
    choices?}] -> per-category + overall scores."""
    per_dataset: Dict[str, List[float]] = defaultdict(list)
    for p in predictions:
        pred = p.get("prediction", p.get("text", ""))
        qtype = p.get("question_type", "open-ended")
        ds = p.get("dataset", "unknown")
        if qtype == "multi-choice" or ds in CATEGORIES["nlrv2"]:
            score = float(judge_multi_choice(pred, p.get("answer", ""),
                                             p.get("choices", [])))
        else:
            score = rouge_l_f(pred, p.get("answer", ""))
        per_dataset[ds].append(score)

    results: Dict[str, float] = {}
    for ds, scores in per_dataset.items():
        results[ds] = sum(scores) / len(scores)
    for cat, datasets in CATEGORIES.items():
        scores = [s for ds in datasets for s in per_dataset.get(ds, [])]
        if scores:
            results[cat] = sum(scores) / len(scores)
    all_scores = [s for ss in per_dataset.values() for s in ss]
    if all_scores:
        results["overall"] = sum(all_scores) / len(all_scores)
    return results


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--result-file", default=None, help="predictions JSONL")
    p.add_argument("--result-dir", default=None,
                   help="directory of chunk JSONLs (the reference "
                        "evaluate_interleave.py --result-dir surface)")
    p.add_argument("--output", default=None)
    args = p.parse_args(argv)
    if not args.result_file and not args.result_dir:
        p.error("one of --result-file / --result-dir is required")
    paths = ([args.result_file] if args.result_file else
             sorted(glob.glob(os.path.join(args.result_dir, "*.jsonl"))))
    preds = []
    for path in paths:
        with open(path) as f:
            preds += [json.loads(l) for l in f if l.strip()]
    results = evaluate(preds)
    for k, v in sorted(results.items()):
        print(f"{k}: {v:.4f}")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(results, f, indent=2)


if __name__ == "__main__":
    main()

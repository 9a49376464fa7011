"""GPT-assisted video-QA scoring (a copy of
`memory_augmented_vlm_tpu/eval/gpt_eval.py`, which has no framework code) —
the working counterpart of the scorer
entries the reference eval suites invoke but do not ship
(`scripts/video/eval/activitynet_eval.sh:35` -> eval_activitynet_qa.py,
`scripts/video/eval/video_chatgpt_benchmark_eval_shard.sh:95-234` ->
evaluate_benchmark_{1..5}_*.py, `video_detail_description_eval_only.sh:18`):
those python files are absent from the reference tree, so the protocol is
reimplemented here from the scripts' call surface.

Protocol (Video-ChatGPT quantitative evaluation): for each sample an LLM
judge is shown (question, correct answer, predicted answer) and returns
``{"pred": "yes"|"no", "score": 0..5}`` for QA correctness, or
``{"score": 0..5}`` for the five benchmark axes (correctness, detailed
orientation, contextual understanding, temporal understanding, consistency).
Aggregates: accuracy = yes/(yes+no) and mean score.

The judge is pluggable:
  * ``--api_key`` + an importable ``openai`` package -> the reference's
    OpenAI judge (same message shape).
  * otherwise -> a deterministic offline token-F1 heuristic judge (clearly
    labeled in the output JSON) so the suites run end-to-end offline.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import re
from typing import Callable, Dict, List, Optional

Judge = Callable[[List[dict]], dict]  # messages -> {"pred":..., "score":...}

_AXES = {
    "correctness": (
        "factual accuracy of the predicted answer compared with the video "
        "description; penalize hallucinated or contradicted facts"),
    "detailed_orientation": (
        "level of detail of the predicted answer: completeness (covers the "
        "major points) and specificity (concrete details over generalities)"),
    "context": (
        "contextual understanding: whether the predicted answer aligns with "
        "the overall context of the video content"),
    "temporal": (
        "temporal understanding: whether the order of events in the "
        "predicted answer matches the video"),
    "consistency": (
        "consistency between the two predicted answers given to two "
        "differently-phrased versions of the same question"),
}


def qa_messages(question: str, answer: str, pred: str) -> List[dict]:
    """The ActivityNet-QA yes/no + 0-5 judge conversation."""
    return [
        {"role": "system", "content":
            "You are an intelligent chatbot designed for evaluating the "
            "correctness of generative outputs for question-answer pairs. "
            "Your task is to compare the predicted answer with the correct "
            "answer and determine if they match meaningfully. Consider "
            "synonyms and paraphrases as valid matches."},
        {"role": "user", "content":
            "Please evaluate the following video-based question-answer "
            f"pair:\n\nQuestion: {question}\nCorrect Answer: {answer}\n"
            f"Predicted Answer: {pred}\n\n"
            "Provide your evaluation only as a yes/no and score where the "
            "score is an integer value between 0 and 5, with 5 indicating "
            "the highest meaningful match. Respond as a Python dictionary "
            "string with keys 'pred' and 'score'."},
    ]


def axis_messages(axis: str, question: str, answer: str, pred: str,
                  pred2: Optional[str] = None) -> List[dict]:
    """One of the five benchmark-axis judge conversations (0-5 score)."""
    crit = _AXES[axis]
    if axis == "consistency":
        body = (f"Question: {question}\nCorrect Answer: {answer}\n"
                f"Predicted Answer to the first phrasing: {pred}\n"
                f"Predicted Answer to the second phrasing: {pred2}\n")
    else:
        body = (f"Question: {question}\nCorrect Answer: {answer}\n"
                f"Predicted Answer: {pred}\n")
    return [
        {"role": "system", "content":
            "You are an intelligent chatbot designed for evaluating the "
            f"quality of generative outputs for video-based question-answer "
            f"pairs. Your task is to rate the {crit}."},
        {"role": "user", "content":
            f"Please evaluate the following video-based question-answer "
            f"pair:\n\n{body}\nProvide your evaluation only as a score "
            "where the score is an integer value between 0 and 5, with 5 "
            "indicating the highest quality. Respond as a Python dictionary "
            "string with the key 'score'."},
    ]


# --------------------------------------------------------------------------
# judges

def openai_judge(api_key: str, model: str = "gpt-3.5-turbo") -> Judge:
    import openai  # imported here: not a dependency of the repository

    client = openai.OpenAI(api_key=api_key)

    def judge(messages: List[dict]) -> dict:
        resp = client.chat.completions.create(model=model, messages=messages)
        return parse_judge_reply(resp.choices[0].message.content)

    return judge


_WORD = re.compile(r"[a-z0-9]+")


def _tokens(s: str) -> List[str]:
    return _WORD.findall(s.lower())


def token_f1(a: str, b: str) -> float:
    """Bag-of-words F1 between two strings (deterministic offline judge)."""
    ta, tb = _tokens(a), _tokens(b)
    if not ta or not tb:
        return float(ta == tb)
    common: Dict[str, int] = {}
    cb: Dict[str, int] = {}
    for t in tb:
        cb[t] = cb.get(t, 0) + 1
    n = 0
    for t in ta:
        if cb.get(t, 0) > 0:
            cb[t] -= 1
            n += 1
    if n == 0:
        return 0.0
    p, r = n / len(ta), n / len(tb)
    return 2 * p * r / (p + r)


def offline_judge(messages: List[dict]) -> dict:
    """Deterministic heuristic judge: token-F1 between the 'Correct Answer'
    and 'Predicted Answer' lines of the user message, mapped to the judge's
    output contract. A stand-in for environments without an OpenAI key —
    results are labeled as heuristic in the output JSON."""
    user = messages[-1]["content"]

    def field(name: str) -> str:
        m = re.search(rf"{name}: (.*)", user)
        return m.group(1) if m else ""

    answer = field("Correct Answer")
    pred = field(r"Predicted Answer(?: to the first phrasing)?")
    pred2 = field("Predicted Answer to the second phrasing")
    f1 = token_f1(answer, pred)
    if pred2:
        f1 = token_f1(pred, pred2)  # consistency compares the two preds
    return {"pred": "yes" if f1 >= 0.5 else "no",
            "score": int(round(5 * f1))}


def parse_judge_reply(text: str) -> dict:
    """Parse the judge's "Python dictionary string" reply robustly."""
    m = re.search(r"\{.*\}", text, re.S)
    if not m:
        raise ValueError(f"unparseable judge reply: {text!r}")
    import ast

    d = ast.literal_eval(m.group(0))
    out = {}
    if "pred" in d:
        out["pred"] = str(d["pred"]).strip().lower()
    if "score" in d:
        out["score"] = float(d["score"])
    return out


# --------------------------------------------------------------------------
# aggregation

def load_preds(pred_path: str) -> List[dict]:
    """Load predictions from a file or a directory of chunk jsonls
    (the `--num_chunks` merge step of the reference scripts)."""
    if os.path.isdir(pred_path):
        rows: List[dict] = []
        for f in sorted(glob.glob(os.path.join(pred_path, "*.jsonl"))):
            rows += load_preds(f)
        return rows
    with open(pred_path) as f:
        if pred_path.endswith(".json"):
            return json.load(f)
        return [json.loads(line) for line in f if line.strip()]


def attach_gt(preds: List[dict], gt_questions: Optional[str],
              gt_answers: Optional[str]) -> List[dict]:
    """ActivityNet layout: separate id-keyed question/answer files
    (the reference's --gt_file_question/--gt_file_answers)."""
    if not gt_questions:
        return preds
    with open(gt_questions) as f:
        qs = {str(q.get("question_id", q.get("id"))): q for q in json.load(f)}
    ans = {}
    if gt_answers:
        with open(gt_answers) as f:
            ans = {str(a.get("question_id", a.get("id"))): a
                   for a in json.load(f)}
    out = []
    for p in preds:
        qid = str(p.get("question_id", p.get("id")))
        q = qs.get(qid, {})
        a = ans.get(qid, {})
        out.append({**p,
                    "question": p.get("question") or q.get("question", ""),
                    "answer": p.get("answer") or a.get("answer", "")})
    return out


def evaluate(preds: List[dict], mode: str, judge: Judge) -> dict:
    """Run the judge over every sample and aggregate."""
    per_sample, yes, scores = [], 0, []
    for p in preds:
        q = p.get("question", p.get("prompt", ""))
        a = p.get("answer", "")
        pred = p.get("pred", p.get("text", ""))
        if mode == "qa":
            msgs = qa_messages(q, a, pred)
        else:
            msgs = axis_messages(mode, q, a, pred, p.get("pred2"))
        v = judge(msgs)
        per_sample.append({**p, "judge": v})
        if v.get("pred") == "yes":
            yes += 1
        if "score" in v:
            scores.append(v["score"])
    result = {"mode": mode, "n": len(per_sample),
              "avg_score": sum(scores) / len(scores) if scores else 0.0}
    if mode == "qa":
        result["accuracy"] = yes / len(per_sample) if per_sample else 0.0
    return {"result": result, "per_sample": per_sample}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--pred_path", required=True,
                   help="answers jsonl, json, or a directory of chunk jsonls")
    p.add_argument("--mode", default="qa",
                   choices=["qa"] + sorted(_AXES))
    p.add_argument("--gt_file_question", default=None)
    p.add_argument("--gt_file_answers", default=None)
    p.add_argument("--output_json", default=None)
    p.add_argument("--api_key", default=None)
    p.add_argument("--judge_model", default="gpt-3.5-turbo")
    args = p.parse_args(argv)

    if args.api_key:
        judge, judge_name = openai_judge(args.api_key, args.judge_model), \
            f"openai:{args.judge_model}"
    else:
        judge, judge_name = offline_judge, "offline-token-f1(heuristic)"

    preds = attach_gt(load_preds(args.pred_path),
                      args.gt_file_question, args.gt_file_answers)
    out = evaluate(preds, args.mode, judge)
    out["result"]["judge"] = judge_name
    print(json.dumps(out["result"]))
    if args.output_json:
        os.makedirs(os.path.dirname(os.path.abspath(args.output_json)),
                    exist_ok=True)
        with open(args.output_json, "w") as f:
            json.dump(out, f, indent=1)
    return out["result"]


if __name__ == "__main__":
    main()

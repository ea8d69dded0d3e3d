"""Command line of the port (counterpart of `lpi_tpu/cli/main.py`):
continual retrieval and grounding training, evaluation from saved
sessions, the grounding demo and result post-processing.

    python -m lpi_tpu_torch.cli.main train --synthetic --sessions 2 --epochs 1
    python -m lpi_tpu_torch.cli.main train-grounding --synthetic --tasks 2 --epochs 1
    python -m lpi_tpu_torch.cli.main eval-all --synthetic --grounding \\
        --checkpoint-dir checkpoints_grounding
    python -m lpi_tpu_torch.cli.main predict image.png "a dog on a bench" \\
        --checkpoint-dir checkpoints_grounding
    python -m lpi_tpu_torch.cli.main predict image.png --classes dog,bench \\
        --knowledge-file knowledge.json
    python -m lpi_tpu_torch.cli.main report res/<timestamp>.json --metric i2t

Every command that runs a model runs it on the card; `--platform cpu` runs
it on the CPU (the kernels' plain versions), and without a card and without
that flag the command fails. The training commands save the frozen base at
the first session and each session's pools, task keys and evaluation after
it (`core.checkpoint.SessionCheckpointer`), and write the run's result json
(`core.logging.save_results_json`, the JAX package's schema). Training and
evaluation run under `lpi_tpu_torch.bench.deterministic()`, so that a
session evaluated again from its checkpoint gives the numbers recorded when
it was trained. `--config` takes the nested-json overrides of
`lpi_tpu_torch.config.load_config`.

`predict --classes` runs GLIP-KNOW's detection mode
(`GroundingPredictor.predict_classes`) with the config's `knowledge`
settings. The commands whose modules are not ported yet (`serve`,
`eval-detection`, `fetch-weights`, `train-grounding --dataset`) stay in the
parser and exit non-zero, naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

NOT_PORTED = {
    "serve": "serve (the gradio webui) is not ported yet (ROADMAP §A.3)",
    "eval-detection": "eval-detection (the COCO, LVIS, Flickr and VOC evaluators) is not "
                      "ported yet (ROADMAP §A.6)",
    "fetch-weights": "fetch-weights (core/fetch.py) is not ported yet (ROADMAP §A.5)",
}
DATASET_NOT_PORTED = "--dataset needs data/catalog.py, which is not ported yet (ROADMAP §A.3)"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("lpi_tpu_torch")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"],
                   help="where the model runs: the card (default) or the CPU")
    sub = p.add_subparsers(dest="command", required=True)

    t = sub.add_parser("train", help="run the continual retrieval loop")
    t.add_argument("--config", default=None, help="nested-json config overrides")
    t.add_argument("--ann-train", default=None)
    t.add_argument("--ann-val", default=None)
    t.add_argument("--image-root", default=None)
    t.add_argument("--clip-ckpt", default=None, help="OpenAI CLIP .pt to convert")
    t.add_argument("--task-sim", default=None, help="task_sim_matrix.txt path")
    t.add_argument("--synthetic", action="store_true", help="synthetic data smoke run")
    t.add_argument("--sessions", type=int, default=None)
    t.add_argument("--epochs", type=int, default=None)
    t.add_argument("--output-dir", default="res")
    t.add_argument("--checkpoint-dir", default="checkpoints")
    t.add_argument("--tensorboard-dir", default=None,
                   help="also export per-session metrics as TensorBoard event files")

    g = sub.add_parser("train-grounding", help="run the continual grounding loop")
    g.add_argument("--config", default=None)
    g.add_argument("--ann", default=None, help="mdetr refexp annotation json")
    g.add_argument("--image-root", default=None)
    g.add_argument("--dataset", default=None,
                   help="catalog name (e.g. refexp_train); not ported yet")
    g.add_argument("--glip-ckpt", default=None, help="GLIP-T .pth to convert")
    g.add_argument("--bert-vocab", default=None)
    g.add_argument("--task-sim", default=None)
    g.add_argument("--synthetic", action="store_true")
    g.add_argument("--tasks", type=int, default=None)
    g.add_argument("--epochs", type=int, default=None)
    g.add_argument("--output-dir", default="FINAL_RES")
    g.add_argument("--checkpoint-dir", default="checkpoints_grounding")
    g.add_argument("--tensorboard-dir", default=None,
                   help="also export per-task metrics as TensorBoard event files")

    d = sub.add_parser("predict", help="grounding demo on one image")
    d.add_argument("image")
    d.add_argument("caption", nargs="?", default=None,
                   help="grounding caption; omit when using --classes")
    d.add_argument("--config", default=None)
    d.add_argument("--checkpoint-dir", default=None)
    d.add_argument("--bert-vocab", default=None)
    d.add_argument("--output", default="prediction.png")
    d.add_argument("--thresh", type=float, default=0.5)
    d.add_argument("--classes", default=None,
                   help="comma-separated class names (GLIP-KNOW detection)")
    d.add_argument("--knowledge-file", default=None,
                   help="GLIPKNOW knowledge json expanding --classes into "
                   "knowledge-augmented captions (the config's knowledge settings)")

    s = sub.add_parser("serve", help="launch the gradio grounding webui (not ported yet)")
    s.add_argument("--config", default=None)
    s.add_argument("--checkpoint-dir", default=None)
    s.add_argument("--bert-vocab", default=None)
    s.add_argument("--port", type=int, default=7860)

    e = sub.add_parser("eval", help="standalone retrieval eval from a checkpoint")
    e.add_argument("--config", default=None)
    e.add_argument("--checkpoint-dir", required=True)
    e.add_argument("--session", type=int, default=None)
    e.add_argument("--ann-val", default=None)
    e.add_argument("--image-root", default=None)
    e.add_argument("--synthetic", action="store_true")

    ea = sub.add_parser("eval-all", help="evaluate every saved session checkpoint")
    ea.add_argument("--config", default=None)
    ea.add_argument("--checkpoint-dir", required=True)
    ea.add_argument("--ann-val", default=None)
    ea.add_argument("--image-root", default=None)
    ea.add_argument("--synthetic", action="store_true")
    ea.add_argument("--grounding", action="store_true",
                    help="sweep grounding task checkpoints instead of retrieval sessions")
    ea.add_argument("--bert-vocab", default=None)
    ea.add_argument("--output", default=None, help="write the per-session summary json here")

    r = sub.add_parser("report", help="aggregate a result json (reshandle)")
    r.add_argument("result_json")
    r.add_argument("--metric", default="i2t", choices=["i2t", "t2i"])
    r.add_argument("--dataset", default="mscoco")
    r.add_argument("--sessions", type=int, default=12)

    ed = sub.add_parser("eval-detection",
                        help="score a predictions json against GT (not ported yet)")
    ed.add_argument("predictions")
    ed.add_argument("--gt", required=True)
    ed.add_argument("--protocol", default="coco", choices=["coco", "lvis", "flickr", "voc"])
    ed.add_argument("--max-dets", type=int, default=None)
    ed.add_argument("--merge-boxes", action="store_true")

    fw = sub.add_parser("fetch-weights", help="download and convert pretrained weights "
                                              "(not ported yet)")
    fw.add_argument("name", nargs="?", default=None)
    fw.add_argument("--root", default=None)
    fw.add_argument("--no-convert", action="store_true")
    fw.add_argument("--list", action="store_true", dest="list_entries")
    return p


def _device(platform: str) -> str:
    if platform == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the port runs on the card; pass --platform cpu to "
                         "run on the CPU")
    return "cuda"


def _sim(path, num_tasks: int) -> np.ndarray:
    from lpi_tpu_torch.continual.mid import fallback_sim_matrix, load_task_sim_matrix

    return load_task_sim_matrix(path, num_tasks) if path else fallback_sim_matrix(num_tasks)


def _sessions(ckpt, directory: str) -> list:
    latest = ckpt.latest_session()
    if latest is None:
        raise SystemExit(f"no sessions found in {directory}")
    return [s for s in range(latest + 1)
            if os.path.isdir(os.path.join(directory, f"session_{s}"))]


def _bert_tokenizer(args, gcfg):
    from lpi_tpu_torch.data.bert_tokenizer import BertTokenizer

    return BertTokenizer(vocab_path=args.bert_vocab, max_len=gcfg.bert.max_query_len,
                         vocab_size=gcfg.bert.vocab_size)


def _retrieval_eval_set(args, rcfg, tok, session: int):
    """The cumulative eval set of sessions 0..session."""
    if args.synthetic:
        from lpi_tpu_torch.data.retrieval import synthetic_eval

        return synthetic_eval(session + 1, 8, image_size=rcfg.clip.image_resolution,
                              tokenizer=tok, n_ctx=rcfg.clip.n_ctx)
    from lpi_tpu_torch.data.coco import load_coco_eval

    return load_coco_eval(args.ann_val, args.image_root, list(range(session + 1)), tok,
                          rcfg.clip.n_ctx)


def _grounding_task_sets(args, gcfg, tok, tasks: int, ann: str) -> dict:
    from lpi_tpu_torch.data.grounding import load_mdetr_refexp, synthetic_grounding_task

    if args.synthetic:
        return {t: synthetic_grounding_task(t, max(gcfg.batch_size * 2, 8), gcfg.image_size,
                                            tok, gcfg.max_boxes) for t in range(tasks)}
    return {t: load_mdetr_refexp(ann, args.image_root, t, tok, gcfg.image_size, gcfg.max_boxes)
            for t in range(tasks)}


def cmd_train(args):
    """The continual retrieval loop. -> (the result json's path, the
    learner)."""
    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.core.logging import MetricLogger, save_results_json, setup_logging
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    if not args.synthetic and not (args.ann_train and args.ann_val and args.image_root):
        raise SystemExit("need --ann-train/--ann-val/--image-root (or --synthetic)")
    log = setup_logging(args.output_dir)
    rcfg = load_config(args.config).retrieval
    sessions = args.sessions or rcfg.total_sessions
    init_params = None
    if args.clip_ckpt:
        from lpi_tpu_torch.models.clip.convert import load_torch_clip

        init_params = load_torch_clip(args.clip_ckpt)
        log.info("loaded CLIP weights from %s", args.clip_ckpt)
    learner = RetrievalLearner(rcfg, task_sim_matrix=_sim(args.task_sim, rcfg.total_sessions),
                               init_params=init_params, device=args.device)

    tok = ClipTokenizer()
    size = rcfg.clip.image_resolution
    if args.synthetic:
        from lpi_tpu_torch.data.retrieval import synthetic_session

        train_sets = [synthetic_session(t, max(rcfg.batch_size * 2, 16), size, tok,
                                        rcfg.clip.n_ctx) for t in range(sessions)]
    else:
        from lpi_tpu_torch.data.coco import CocoCaptionTrain

        train_sets = [CocoCaptionTrain(args.ann_train, args.image_root, [t], tok,
                                       rcfg.clip.n_ctx) for t in range(sessions)]

    ckpt = SessionCheckpointer(args.checkpoint_dir)
    ml = MetricLogger(jsonl_path=os.path.join(args.output_dir, "metrics.jsonl"),
                      tensorboard_dir=args.tensorboard_dir)
    results = {}
    with deterministic():
        for i in range(sessions):
            log.info("=== session %d/%d (task %d) ===", i + 1, sessions,
                     train_sets[i].task_index)
            metrics = learner.train_session(train_sets[i], epochs=args.epochs)
            log.info("train metrics: %s", metrics)
            res = learner.evaluate(_retrieval_eval_set(args, rcfg, tok, i), num_tasks=i + 1)
            log.info("eval r_mean=%.2f task_acc=%s", res["summary"]["r_mean"],
                     res["task_id_accuracy"])
            ml.update(session=i, **metrics, r_mean=res["summary"]["r_mean"],
                      task_id_acc_visual=res["task_id_accuracy"]["visual"])
            results[i] = {"mscoco": {"i2t": res["i2t"], "t2i": res["t2i"]},
                          "summary": res["summary"],
                          "task_id_accuracy": res["task_id_accuracy"]}
            if i == 0:
                ckpt.save_base(learner.frozen)
            ckpt.save_session(i, learner.pools, learner.visual_keys, learner.textual_keys,
                              results[i])
    ml.close()
    path = save_results_json(results, args.output_dir)
    log.info("results written to %s", path)
    return path, learner


def cmd_train_grounding(args):
    """The continual grounding loop. -> (the result json's path, the
    learner)."""
    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.core.logging import MetricLogger, save_results_json, setup_logging

    if args.dataset:
        raise SystemExit(DATASET_NOT_PORTED)
    if not args.synthetic and not (args.ann and args.image_root):
        raise SystemExit("need --ann/--image-root (or --synthetic)")
    log = setup_logging(args.output_dir)
    gcfg = load_config(args.config).grounding
    tasks = args.tasks or gcfg.total_tasks
    tok = _bert_tokenizer(args, gcfg)
    task_sets = _grounding_task_sets(args, gcfg, tok, tasks, args.ann)
    learner = GroundingLearner(gcfg, task_sim_matrix=_sim(args.task_sim, gcfg.total_tasks),
                               device=args.device)
    if args.glip_ckpt:
        from lpi_tpu_torch.models.glip.convert import convert_glip, merge_into_params

        sd = torch.load(args.glip_ckpt, map_location="cpu", weights_only=True)
        converted, unmapped = convert_glip(sd.get("model", sd))
        log.info("GLIP ckpt: %d leaves converted, %d unmapped", len(converted), len(unmapped))
        learner.model.load_state_dict(merge_into_params(learner.model.state_dict(), converted,
                                                        strict_shapes=False))

    ckpt = SessionCheckpointer(args.checkpoint_dir)
    ml = MetricLogger(jsonl_path=os.path.join(args.output_dir, "metrics.jsonl"),
                      tensorboard_dir=args.tensorboard_dir)
    results = {}
    with deterministic():
        for tid in range(tasks):
            log.info("=== grounding task %d/%d ===", tid + 1, tasks)
            metrics = learner.train_task(task_sets[tid], epochs=args.epochs)
            log.info("train metrics: %s", metrics)
            res = learner.evaluate({t: task_sets[t] for t in range(tid + 1)})
            log.info("eval: %s", res)
            results[tid] = res
            ml.update(task=tid, **metrics, p1_overall=res["overall"][0],
                      task_id_acc=res["task_id_accuracy"])
            if tid == 0:
                ckpt.save_base(learner.frozen)
            ckpt.save_session(tid, learner.pools, visual_keys=learner.keys, results=res)
    ml.close()
    path = save_results_json(results, args.output_dir, stem="res_grounding")
    log.info("results written to %s", path)
    return path, learner


def cmd_predict(args) -> dict:
    """One-image grounding demo: the overlay written to `--output`, the
    detections printed as JSON. -> the predictor's result."""
    from PIL import Image

    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.data.knowledge import load_knowledge_file
    from lpi_tpu_torch.serve.predictor import GroundingPredictor, draw_predictions

    if not (args.classes or args.caption):
        raise SystemExit("predict needs a caption or --classes")
    gcfg = load_config(args.config).grounding
    learner = GroundingLearner(gcfg, device=args.device)
    if args.checkpoint_dir:
        learner.restore(SessionCheckpointer(args.checkpoint_dir))
    predictor = GroundingPredictor(learner.model, learner.keys, _bert_tokenizer(args, gcfg),
                                   image_size=gcfg.image_size, score_thresh=args.thresh,
                                   atss_cfg=gcfg.atss, device=args.device)
    image = np.asarray(Image.open(args.image).convert("RGB"))
    with deterministic():
        if args.classes:
            know = load_knowledge_file(args.knowledge_file) if args.knowledge_file else None
            kc = gcfg.knowledge
            result = predictor.predict_classes(
                image, [c.strip() for c in args.classes.split(",") if c.strip()],
                knowledge=know, knowledge_type=kc.knowledge_type, gpt3_num=kc.gpt3_num,
                wiki_and_gpt3=kc.wiki_and_gpt3, agg_type=kc.lan_feature_agg_type)
        else:
            result = predictor.predict(image, args.caption)
    draw_predictions(image, result).save(args.output)
    print(json.dumps({
        "entities": result["entities"],
        "scores": [float(s) for s in result["scores"]],
        "boxes": [[float(v) for v in b] for b in result["boxes"]],
        "task_id": result.get("task_id", 0),
        "output": args.output,
    }, indent=2))
    return result


def cmd_eval(args) -> dict:
    """Retrieval evaluation of one saved session (the latest by default).
    -> the evaluation."""
    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.continual.learner import RetrievalLearner
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.core.logging import setup_logging
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    if not args.synthetic and not (args.ann_val and args.image_root):
        raise SystemExit("need --ann-val/--image-root (or --synthetic)")
    log = setup_logging(None)
    rcfg = load_config(args.config).retrieval
    learner = RetrievalLearner(rcfg, device=args.device)
    session = learner.restore(SessionCheckpointer(args.checkpoint_dir), args.session)
    log.info("restored session %d from %s", session, args.checkpoint_dir)
    ev = _retrieval_eval_set(args, rcfg, ClipTokenizer(), session)
    with deterministic():
        res = learner.evaluate(ev, num_tasks=session + 1)
    print(json.dumps({"session": session, "summary": res["summary"],
                      "task_id_accuracy": res["task_id_accuracy"]}, indent=2, default=float))
    return res


def cmd_eval_all(args) -> dict:
    """Evaluate every saved session in a directory, each restored (the
    frozen base and that session's pools and keys) and evaluated over the
    sessions seen by then; `--grounding` sweeps grounding tasks. ->
    {session: summary}, also printed and, with `--output`, written."""
    from lpi_tpu_torch.bench import deterministic
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.core.logging import setup_logging

    if not args.synthetic and not (args.ann_val and args.image_root):
        raise SystemExit("need --ann-val/--image-root (or --synthetic)")
    log = setup_logging(None)
    cfg = load_config(args.config)
    ckpt = SessionCheckpointer(args.checkpoint_dir)
    sessions = _sessions(ckpt, args.checkpoint_dir)
    out = {}
    with deterministic():
        if args.grounding:
            from lpi_tpu_torch.continual.grounding_learner import GroundingLearner

            gcfg = cfg.grounding
            task_sets = _grounding_task_sets(args, gcfg, _bert_tokenizer(args, gcfg),
                                             max(sessions) + 1, args.ann_val)
            learner = GroundingLearner(gcfg, device=args.device)
            for s in sessions:
                learner.restore(ckpt, s)
                res = learner.evaluate({t: task_sets[t] for t in range(s + 1)})
                out[s] = {"overall": res["overall"],
                          "per_task": {str(k): v for k, v in res["per_task"].items()},
                          "task_id_accuracy": res["task_id_accuracy"]}
                log.info("task %02d: P@1/5/10=%s task_id_acc=%.3f", s, res["overall"],
                         res["task_id_accuracy"])
        else:
            from lpi_tpu_torch.continual.learner import RetrievalLearner
            from lpi_tpu_torch.data.tokenizer import ClipTokenizer

            rcfg = cfg.retrieval
            tok = ClipTokenizer()
            learner = RetrievalLearner(rcfg, device=args.device)
            for s in sessions:
                learner.restore(ckpt, s)
                res = learner.evaluate(_retrieval_eval_set(args, rcfg, tok, s),
                                       num_tasks=s + 1)
                out[s] = {"summary": res["summary"],
                          "task_id_accuracy": res["task_id_accuracy"]}
                log.info("session %02d: %s", s, out[s]["summary"])
    print(json.dumps(out, indent=2, default=float))
    if args.output:
        with open(args.output, "w") as f:
            json.dump(out, f, default=float)
    return out


def cmd_report(args) -> dict:
    from lpi_tpu_torch.eval.reshandle import get_res

    res = get_res(args.result_json, dataset=args.dataset, metric=args.metric,
                  num_sessions=args.sessions)
    print(json.dumps(res, indent=2))
    return res


COMMANDS = {"train": cmd_train, "train-grounding": cmd_train_grounding,
            "predict": cmd_predict, "eval": cmd_eval, "eval-all": cmd_eval_all}


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command in NOT_PORTED:
        raise SystemExit(NOT_PORTED[args.command])
    if args.command == "report":  # host only
        return cmd_report(args)
    args.device = _device(args.platform)
    return COMMANDS[args.command](args)


if __name__ == "__main__":
    main()

"""Command line of the port (counterpart of `lpi_tpu/cli/main.py`):
continual retrieval and grounding training, evaluation from saved
sessions, the grounding demo and result post-processing.

    python -m lpi_tpu_torch.cli.main train --synthetic --sessions 2 --epochs 1
    torchrun --nproc-per-node 2 -m lpi_tpu_torch.cli.main train --synthetic
    python -m lpi_tpu_torch.cli.main train-grounding --synthetic --tasks 2 --epochs 1
    DATASET=/data python -m lpi_tpu_torch.cli.main train-grounding --dataset refexp_train
    python -m lpi_tpu_torch.cli.main eval-all --synthetic --grounding \\
        --checkpoint-dir checkpoints_grounding
    python -m lpi_tpu_torch.cli.main predict image.png "a dog on a bench" \\
        --checkpoint-dir checkpoints_grounding
    python -m lpi_tpu_torch.cli.main predict image.png --classes dog,bench \\
        --knowledge-file knowledge.json
    python -m lpi_tpu_torch.cli.main serve --checkpoint-dir checkpoints_grounding --port 7860
    python -m lpi_tpu_torch.cli.main report res/<timestamp>.json --metric i2t
    python -m lpi_tpu_torch.cli.main eval-detection preds.json --gt gt.json --protocol lvis
    python -m lpi_tpu_torch.cli.main fetch-weights clip-vit-b-16

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

`train` under torchrun (`WORLD_SIZE` set) is one rank of a data- and
tensor-parallel run: it starts the process group from the environment
(`core.dist.init_from_env`: NCCL, one card a rank, or gloo with
`--platform cpu`) and builds the mesh from the config's `mesh` section;
rank 0 alone writes the log file, `metrics.jsonl`, the checkpoints (the
frozen base whole, gathered from its tensor-parallel shards) and the
result json. Every other command, as in the JAX package, builds no mesh:
under torchrun with more than one rank it refuses, naming the reason.

`predict --classes` runs GLIP-KNOW's detection mode
(`GroundingPredictor.predict_classes`) with the config's `knowledge`
settings. `train-grounding --dataset NAME` resolves a catalog name
(`data/catalog.py`; mdetr-format names only) to its annotation json and
image directory, each found by `try_to_find` in the working directory,
`$DATASET`, then ./DATASET, ./OUTPUT, ./data and ./MODEL, and runs as with
`--ann/--image-root`. `eval-detection` scores a predictions json against a
ground-truth json with the COCO, LVIS, VOC or Flickr30k protocol
(`eval/{coco_ap,lvis,voc,flickr}.py`, host numpy). `serve` builds the
predictor as `predict` does and hands it to the gradio demo
(`serve.predictor.launch_webui`); without `gradio` installed it fails with
the JAX package's error. `fetch-weights` downloads, verifies and converts a
registry entry (`core/fetch.py`; `--list` prints the registry), on the
host.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

ONE_PROCESS = ("{command} runs in one process, as in the JAX package, which builds no mesh "
               "for it; under torchrun only `train` takes more than one rank "
               "(WORLD_SIZE={world})")


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
                   help="catalog name of an mdetr-format set (e.g. refexp_train)")
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

    s = sub.add_parser("serve", help="launch the gradio grounding webui")
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

    ed = sub.add_parser("eval-detection", help="score a predictions json against GT")
    ed.add_argument("predictions", help="json: per-image records {image_id, boxes (xyxy), "
                                        "scores, labels}; flickr: per-phrase {boxes, scores, "
                                        "gt_boxes, phrase_types}")
    ed.add_argument("--gt", required=True, help="COCO-format ground-truth json (LVIS: with "
                                                "image_count and the federated id lists)")
    ed.add_argument("--protocol", default="coco", choices=["coco", "lvis", "flickr", "voc"])
    ed.add_argument("--max-dets", type=int, default=None)
    ed.add_argument("--merge-boxes", action="store_true",
                    help="flickr: merge each phrase's GT boxes into one")

    fw = sub.add_parser("fetch-weights", help="download and convert pretrained weights")
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
    from lpi_tpu_torch.core.dist import is_main_process
    from lpi_tpu_torch.core.logging import MetricLogger, save_results_json, setup_logging
    from lpi_tpu_torch.core.mesh import gather_params
    from lpi_tpu_torch.data.tokenizer import ClipTokenizer

    if not args.synthetic and not (args.ann_train and args.ann_val and args.image_root):
        raise SystemExit("need --ann-train/--ann-val/--image-root (or --synthetic)")
    mesh, main = getattr(args, "mesh", None), is_main_process()
    log = setup_logging(args.output_dir if main else None)
    rcfg = load_config(args.config).retrieval
    sessions = args.sessions or rcfg.total_sessions
    init_params = None
    if args.clip_ckpt:
        from lpi_tpu_torch.models.clip.convert import load_torch_clip

        init_params = load_torch_clip(args.clip_ckpt)
        log.info("loaded CLIP weights from %s", args.clip_ckpt)
    learner = RetrievalLearner(rcfg, task_sim_matrix=_sim(args.task_sim, rcfg.total_sessions),
                               init_params=init_params, device=args.device, mesh=mesh)
    if mesh is not None:
        log.info("rank %d of a %dx%d (data, model) mesh", torch.distributed.get_rank(),
                 mesh.dp, mesh.mp)

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

    ckpt = SessionCheckpointer(args.checkpoint_dir) if main else None
    ml = MetricLogger(jsonl_path=os.path.join(args.output_dir, "metrics.jsonl"),
                      tensorboard_dir=args.tensorboard_dir) if main else None
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
            results[i] = {"mscoco": {"i2t": res["i2t"], "t2i": res["t2i"]},
                          "summary": res["summary"],
                          "task_id_accuracy": res["task_id_accuracy"]}
            # every rank gathers (a collective), rank 0 writes
            base = gather_params(mesh, learner.frozen, learner.tp_layout) if i == 0 else None
            if not main:
                continue
            ml.update(session=i, **metrics, r_mean=res["summary"]["r_mean"],
                      task_id_acc_visual=res["task_id_accuracy"]["visual"])
            if i == 0:
                ckpt.save_base(base)
            ckpt.save_session(i, learner.pools, learner.visual_keys, learner.textual_keys,
                              results[i])
    if not main:
        return None, learner
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

    if not args.synthetic and not args.dataset and not (args.ann and args.image_root):
        raise SystemExit("need --dataset, --ann/--image-root, or --synthetic")
    if args.dataset:
        from lpi_tpu_torch.data.catalog import CATALOG, try_to_find

        spec = CATALOG.get(args.dataset)
        if spec.kind != "mdetr":
            raise SystemExit(f"--dataset {args.dataset} is {spec.kind}-kind; "
                             "train-grounding takes an mdetr-format name")
        args.ann = try_to_find(spec.ann_file)
        args.image_root = try_to_find(spec.img_dir)
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


def cmd_serve(args):
    """The gradio grounding demo on a predictor built as `predict` builds
    it (the config's grounding model, restored from `--checkpoint-dir` when
    given). -> the predictor, after the demo's `launch` returns."""
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.continual.grounding_learner import GroundingLearner
    from lpi_tpu_torch.core.checkpoint import SessionCheckpointer
    from lpi_tpu_torch.serve.predictor import GroundingPredictor, launch_webui

    gcfg = load_config(args.config).grounding
    learner = GroundingLearner(gcfg, device=args.device)
    if args.checkpoint_dir:
        learner.restore(SessionCheckpointer(args.checkpoint_dir))
    predictor = GroundingPredictor(learner.model, learner.keys, _bert_tokenizer(args, gcfg),
                                   image_size=gcfg.image_size, atss_cfg=gcfg.atss,
                                   device=args.device)
    launch_webui(predictor, port=args.port)
    return predictor


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


def cmd_fetch_weights(args) -> dict:
    """List the registry, or download, verify and convert one entry."""
    from lpi_tpu_torch.core import fetch

    if args.list_entries or args.name is None:
        for name, spec in sorted(fetch.WEIGHTS.items()):
            verified = "sha256" if spec["sha256"] else "unverified"
            print(f"{name:16s} {verified:10s} {spec['url']}")
        if args.name is None:
            return {"available": sorted(fetch.WEIGHTS)}
    out = fetch.fetch_weights(args.name, root=args.root or fetch.DEFAULT_ROOT,
                              convert=not args.no_convert)
    print(f"checkpoint: {out['checkpoint']}")
    print(f"sha256:     {out['sha256']}")
    if out["converted"]:
        print(f"converted:  {out['converted']}")
    return out


def cmd_eval_detection(args) -> dict:
    """Score detection or grounding predictions with the reference's
    protocols: COCO mAP (`eval/coco_ap.py`), federated LVIS AP with its
    r/c/f bins (`eval/lvis.py`), VOC's 07 mAP (`eval/voc.py`) or Flickr30k
    phrase Recall@k (`eval/flickr.py`). Ground-truth boxes are COCO xywh.
    -> the metrics (without per-class values), also printed."""
    with open(args.predictions) as f:
        preds = json.load(f)

    if args.protocol == "flickr":
        from lpi_tpu_torch.eval.flickr import FlickrEvaluator

        ev = FlickrEvaluator(merge_gt_boxes=args.merge_boxes)
        for rec in preds:
            ev.update(rec["boxes"], rec["scores"], rec["gt_boxes"],
                      phrase_types=rec.get("phrase_types"))
        res = ev.summarize()
        print(json.dumps(res, indent=2))
        return res

    with open(args.gt) as f:
        gt = json.load(f)
    anns_by_img = {}
    for a in gt.get("annotations", []):
        anns_by_img.setdefault(a["image_id"], []).append(a)

    def gt_record(image_id):
        anns = anns_by_img.get(image_id, [])
        boxes = [[a["bbox"][0], a["bbox"][1], a["bbox"][0] + a["bbox"][2],
                  a["bbox"][1] + a["bbox"][3]] for a in anns]
        return boxes, [a["category_id"] for a in anns]

    def detections(rec):
        return {"boxes": rec["boxes"], "scores": rec["scores"], "labels": rec["labels"]}

    if args.protocol == "lvis":
        from lpi_tpu_torch.eval.lvis import LvisEvaluator

        counts = {c["id"]: c.get("image_count", 100) for c in gt.get("categories", [])}
        ev = LvisEvaluator(category_image_counts=counts, max_dets=args.max_dets or 300)
        img_meta = {im["id"]: im for im in gt.get("images", [])}
        for rec in preds:
            boxes, labels = gt_record(rec["image_id"])
            meta = img_meta.get(rec["image_id"], {})
            pos = meta.get("not_exhaustive_category_ids")
            neg = meta.get("neg_category_ids")
            federated = pos is not None or neg is not None
            ev.update(rec["boxes"], rec["scores"], rec["labels"], boxes, labels,
                      pos_cats=(pos or []) if federated else None,
                      neg_cats=(neg or []) if federated else None)
        res = ev.summarize()
    elif args.protocol == "voc":
        from lpi_tpu_torch.eval.voc import eval_detection_voc

        gts = []
        for rec in preds:
            boxes, labels = gt_record(rec["image_id"])
            gts.append({"boxes": boxes, "labels": labels,
                        "difficult": [a.get("difficult", 0)
                                      for a in anns_by_img.get(rec["image_id"], [])]})
        out = eval_detection_voc(gts, [detections(rec) for rec in preds])
        res = {"map": out["map"],
               "ap": {i: float(v) for i, v in enumerate(out["ap"]) if v == v}}
    else:
        from lpi_tpu_torch.eval.coco_ap import evaluate_detections

        gts = []
        for rec in preds:
            boxes, labels = gt_record(rec["image_id"])
            gts.append({"boxes": boxes, "labels": labels})
        res = evaluate_detections([detections(rec) for rec in preds], gts,
                                  max_dets=args.max_dets or 100)
    res.pop("per_class", None)
    print(json.dumps(res, indent=2))
    return res


COMMANDS = {"train": cmd_train, "train-grounding": cmd_train_grounding,
            "predict": cmd_predict, "serve": cmd_serve, "eval": cmd_eval,
            "eval-all": cmd_eval_all}
HOST_COMMANDS = {"report": cmd_report, "eval-detection": cmd_eval_detection,  # no model
                 "fetch-weights": cmd_fetch_weights}


def _start_group(args):
    """Under torchrun: `train` starts the process group and builds the
    config's mesh (`args.mesh`, this rank's `args.device`); any other
    command refuses more than one rank."""
    world = int(os.environ["WORLD_SIZE"])
    if args.command != "train":
        if world > 1:
            raise SystemExit(ONE_PROCESS.format(command=args.command, world=world))
        return
    from lpi_tpu_torch.config import load_config
    from lpi_tpu_torch.core.dist import init_from_env
    from lpi_tpu_torch.core.mesh import make_mesh

    args.device = str(init_from_env(args.platform))
    args.mesh = make_mesh(load_config(args.config).mesh)


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.command in HOST_COMMANDS:
        return HOST_COMMANDS[args.command](args)
    if "WORLD_SIZE" in os.environ:
        _start_group(args)
    if getattr(args, "mesh", None) is None:
        args.device = _device(args.platform)
        return COMMANDS[args.command](args)
    try:
        return COMMANDS[args.command](args)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()

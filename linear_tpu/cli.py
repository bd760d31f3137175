"""Command-line interface mirroring the reference's `linear filter`
(src/args_parser.cpp, src/linear.cpp).

Usage: python -m linear_tpu filter [OPTIONS] read.fa/fastq(.gz) genome.fa
Multi-file: python -m linear_tpu filter r1.fa r2.fa x g1.fa g2.fa
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import List


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="linear_tpu",
        description="linear_tpu - alignment-free long-read mapper / SV filter",
    )
    sub = p.add_subparsers(dest="submodule")
    f = sub.add_parser("filter", help="detect SV signals in long reads; outputs SAM/APF")
    f.add_argument("files", nargs="+", help="read files [x] genome files")
    f.add_argument("-o", "--output", default="", help="output prefix")
    f.add_argument("-ot", "--output_type", type=int, default=2,
                   help="1 apf, 2 sam (default), 4 bam; sum to combine")
    f.add_argument("-t", "--thread", type=int, default=16)
    f.add_argument("-g", "--gap_len", type=int, default=1,
                   help="min gap len; 0 disables gap mapping; 1 -> default 50")
    f.add_argument("-rg", "--read_group", default="")
    f.add_argument("-sn", "--sample_name", default="")
    f.add_argument("-ss", "--sequence_sam", type=int, default=0)
    f.add_argument("-dup", "--duplication", type=int, default=0)
    f.add_argument("-b", "--bal_flag", type=int, default=1)
    f.add_argument("-p", "--preset", type=int, default=1,
                   help="effective reference default is 1")
    f.add_argument("-i", "--index_type", type=int, default=1)
    f.add_argument("-a", "--align", type=int, default=0,
                   help="1: base-level banded alignment (real =/X/I/D "
                        "CIGARs). NOTE: the reference accepts no such flag "
                        "(-a is commented out of its parser, "
                        "src/args_parser.cpp:214); functional here")
    f.add_argument("-c", "--apx_c_flag", type=int, default=1)
    f.add_argument("-f", "--feature_type", type=int, default=2)
    f.add_argument("-r", "--reform_ccs_cigar_flag", type=int, default=0)
    f.add_argument("--save-index", default="",
                   help="serialize the built index to PATH(.npz) and continue")
    f.add_argument("--load-index", default="",
                   help="load a previously saved index instead of building "
                        "(must match -i/-t and the genome files)")
    f.add_argument("--device", choices=["host", "accel"], default="host",
                   help="host engine only, or device seeding on the JAX "
                        "accelerator (refuses a CPU backend unless "
                        "JAX_PLATFORMS=cpu)")
    return p


def split_files(files: List[str]) -> tuple:
    """reads... x genomes... Cartesian syntax (src/args_parser.cpp:297)."""
    if "x" in files:
        i = files.index("x")
        return files[:i], files[i + 1:]
    return files[:-1], files[-1:]


def run_filter(args) -> int:
    from .map.mapper import Mapper, MapperConfig
    from .utils import seqio

    read_paths, genome_paths = split_files(args.files)
    if not read_paths or not genome_paths:
        print("E[01]: provide reads and genome files", file=sys.stderr)
        return 1
    # flags accepted by the reference CLI but not implemented here are
    # REJECTED rather than silently ignored (HIndex/legacy features are
    # tracked in ROADMAP.md; silently running a different config is a
    # correctness trap for downstream users)
    if args.index_type not in (1, 2, 3):
        print(f"E[11]: unknown index type -i {args.index_type}; use 1 "
              "(DIndex, default), 2 (HIndex) or 3 (SIndex)", file=sys.stderr)
        return 1
    cfg = MapperConfig(
        gap_len=args.gap_len,
        apx_chain_flag=args.apx_c_flag,
        output_type=args.output_type,
        threads=args.thread,
        index_type=args.index_type,
        preset=args.preset,
        read_group=args.read_group,
        sample_name=args.sample_name,
        # reference quirk: Options ctor guards cmd_line building with
        # `if (length(argv) < 1)` (src/base.cpp:64) which is never true,
        # so the @PG CL: tag is ALWAYS empty in the reference's output
        cmd_line="",
        sequence_sam=args.sequence_sam,
        reform_ccs=args.reform_ccs_cigar_flag,
        f_dup=args.duplication,
        bal_flag=args.bal_flag,
        feature_t=args.feature_type,
        aln_flag=args.align,
    )
    t0 = time.time()
    mapper = Mapper(genome_paths, cfg, device=args.device)
    if len(mapper.genomes) >= 1024:
        # reference guard (src/linear.cpp:106-113): cord genome-id is 10 bits
        print("E[m01G]: Too many reference genoemes <=1024", file=sys.stderr)
        return 1
    print(f"--Read genomes  {len(mapper.genomes)} sequences "
          f"{sum(mapper.genome_lens) >> 20} mbases", file=sys.stderr)
    if args.load_index:
        from .index.serial import load_index

        mapper.create_features()
        try:
            mapper.index = load_index(args.load_index,
                                      expect_index_type=args.index_type,
                                      genome_lens=mapper.genome_lens)
        except ValueError as e:
            print(str(e), file=sys.stderr)
            return 1
        print(f"--Index loaded  {args.load_index}", file=sys.stderr)
    else:
        mapper.prepare()
    if args.save_index:
        from .index.serial import save_index

        save_index(args.save_index, mapper.index,
                   genome_lens=mapper.genome_lens)
        print(f"--Index saved   {args.save_index}", file=sys.stderr)
    print(f"--Index created Elapsed time[s] {time.time() - t0:.2f}", file=sys.stderr)

    # -b 1 (default): pipelined fetch/compute/print with a worker pool —
    # the process3 analog (src/linear.cpp:67). -b 0: serial block loop.
    pipeline = None
    if args.bal_flag:
        import os

        from .parallel.pipeline import PipelineMapper

        pipeline = PipelineMapper(
            mapper, n_workers=max(1, min(args.thread, (os.cpu_count() or 1) + 1)),
            csize_workers=max(1, args.thread))
    dev = None
    if args.device == "accel":
        # the first JAX call of the process: after the pool's fork
        from .utils.jaxcfg import accel_device

        try:
            dev = accel_device()
        except RuntimeError as e:
            print(f"E[d01]: {e}", file=sys.stderr)
            if pipeline is not None:
                pipeline.close()
            return 1
        print(f"--Device  {dev.platform} {dev.device_kind}", file=sys.stderr)

    from .out import bam as BAM
    from .out import bamlink as BL

    f_apf = args.output_type & 1
    f_sam = args.output_type & 2
    f_bam = args.output_type & 4
    f_pbsv = args.output_type & 8
    n_done = 0
    # with -o and multiple read files the reference routes EVERY input into
    # the one shared output set (append across files, single header,
    # src/mapper.cpp:601-613 open_mapper_of append + :981-1003); without
    # -o each input file gets its own <name>.sam/.apf
    shared = bool(args.output)
    of_sam_shared = of_apf_shared = None
    bam_shared: list = []
    if shared:
        of_sam_shared = open(args.output + ".sam", "w") if f_sam else None
        of_apf_shared = open(args.output + ".apf", "w") if f_apf else None
        if of_sam_shared:
            of_sam_shared.write(mapper.sam_header())
    for rpath in read_paths:
        prefix = args.output or rpath.split("/")[-1].split(".")[0]
        if shared:
            of_sam, of_apf, bam_lines = of_sam_shared, of_apf_shared, bam_shared
        else:
            of_sam = open(prefix + ".sam", "w") if f_sam else None
            of_apf = open(prefix + ".apf", "w") if f_apf else None
            bam_lines = []
            if of_sam:
                of_sam.write(mapper.sam_header())
        t1 = time.time()

        def emit(block, cs, ce, sam, bl, n=None):
            nonlocal n_done
            if f_bam or f_pbsv:
                bam_lines.extend(bl)
            if of_sam:
                of_sam.write(sam)
            if of_apf:
                of_apf.write(mapper.apf_block(cs, block))
            n_done += len(block) if n is None else n
            el = time.time() - t1
            print(f"  Processed:{n_done}  time:{el:.2f}[s]  "
                  f"speed:{n_done / max(el, 1e-9):.2f}[reads/s]", file=sys.stderr)

        if pipeline is not None:
            for br in pipeline.run(rpath, collect_bam=bool(f_bam or f_pbsv),
                                   collect_cords=bool(f_apf)):
                emit(br.block, br.cords_str, br.cords_end, br.sam,
                     br.bam_lines, n=br.n)
        else:
            for block in seqio.read_blocks(rpath):
                if f_bam or f_pbsv:
                    cs, ce, sam, bl = mapper.map_block(block, collect_bam=True)
                else:
                    cs, ce, sam = mapper.map_block(block)
                    bl = []
                emit(block, cs, ce, sam, bl)
        if not shared:
            for of in (of_sam, of_apf):
                if of:
                    of.close()
            if f_bam:
                BAM.write_bam(prefix + ".bam", mapper.sam_header(),
                              mapper.genome_ids, mapper.genome_lens, bam_lines)
            if f_pbsv:
                hdr = BL.sam_header_pbsv(mapper.genome_ids, mapper.genome_lens,
                                         cfg.read_group, cfg.sample_name,
                                         cfg.cmd_line)
                BAM.write_bam(prefix + "_pbsv.bam", hdr,
                              mapper.genome_ids, mapper.genome_lens, bam_lines)
            outs = [prefix + ext for ext, fl in
                    ((".apf", f_apf), (".sam", f_sam), (".bam", f_bam),
                     ("_pbsv.bam", f_pbsv)) if fl]
            print("Result files: " + " ".join(outs), file=sys.stderr)
    if shared:
        for of in (of_sam_shared, of_apf_shared):
            if of:
                of.close()
        if f_bam:
            BAM.write_bam(args.output + ".bam", mapper.sam_header(),
                          mapper.genome_ids, mapper.genome_lens, bam_shared)
        if f_pbsv:
            hdr = BL.sam_header_pbsv(mapper.genome_ids, mapper.genome_lens,
                                     cfg.read_group, cfg.sample_name,
                                     cfg.cmd_line)
            BAM.write_bam(args.output + "_pbsv.bam", hdr,
                          mapper.genome_ids, mapper.genome_lens, bam_shared)
        outs = [args.output + ext for ext, fl in
                ((".apf", f_apf), (".sam", f_sam), (".bam", f_bam),
                 ("_pbsv.bam", f_pbsv)) if fl]
        print("Result files: " + " ".join(outs), file=sys.stderr)
    if pipeline is not None:
        pipeline.close()
        if dev is not None:
            print(f"--Device  {dev.platform} seeded {pipeline.seeded} of "
                  f"{pipeline.fetched} reads ({pipeline.seeds_used} shipped "
                  "with device seeds)", file=sys.stderr)
    print(f"Time in sum[s] {time.time() - t0:.2f}", file=sys.stderr)
    return 0


def main(argv: List[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.submodule == "filter":
        return run_filter(args)
    parser.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())

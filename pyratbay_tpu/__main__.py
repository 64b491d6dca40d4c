"""Command-line entry point: pbay-tpu -c config.cfg

Reference behavior: pyratbay/__main__.py (pbay console script).
"""
import argparse
import sys


def main():
    parser = argparse.ArgumentParser(
        description='Radiative transfer in a Bayesian framework (JAX)',
        prog='pbay-tpu',
    )
    parser.add_argument(
        '-v', '--version', action='store_true',
        help='show the version number and exit',
    )
    parser.add_argument(
        '-c', '--cfile', metavar='CONFIG', help='configuration file to run',
    )
    parser.add_argument(
        '--root', default=None,
        help="path substituted for '{ROOT}' in config paths",
    )
    parser.add_argument(
        '-pf', nargs='*', metavar='ARGS',
        help='partition-function tools: "-pf tips MOLECULE [OUTFILE]"',
    )
    parser.add_argument(
        '-cs', nargs='*', metavar='ARGS',
        help='cross-section reformat: "-cs hitran FILE [TSTEP [WSTEP]]" '
             'or "-cs borysow FILE SPECIES1 SPECIES2"',
    )
    parser.add_argument(
        '--post', metavar='CONFIG', default=None,
        help='post-process a saved retrieval posterior',
    )
    parser.add_argument(
        '-suf', dest='suffix', default='',
        help='suffix for post-processed output files',
    )
    args = parser.parse_args()

    if args.version:
        from .version import __version__
        print(f'pyratbay_tpu version {__version__}')
        return 0

    if args.pf is not None:
        from .opacity import partitions
        from .io import io as pio
        if len(args.pf) >= 2 and args.pf[0] == 'tips':
            pf, isotopes, temp = partitions.tips(args.pf[1])
            outfile = (
                args.pf[2] if len(args.pf) > 2
                else f'PF_tips_{args.pf[1]}.dat'
            )
            pio.write_pf(outfile, pf, isotopes, temp)
            print(f"Written partition-function file: '{outfile}'")
            return 0
        print('Usage: pbay-tpu -pf tips MOLECULE [OUTFILE]')
        return 1

    if args.cs is not None:
        from . import tools
        if len(args.cs) >= 2 and args.cs[0] == 'hitran':
            tstep = int(args.cs[2]) if len(args.cs) > 2 else 1
            wstep = int(args.cs[3]) if len(args.cs) > 3 else 1
            written = tools.cia_hitran(args.cs[1], tstep, wstep)
            for path in written:
                print(f"Written cross-section file: '{path}'")
            return 0
        if len(args.cs) == 4 and args.cs[0] == 'borysow':
            path = tools.cia_borysow(args.cs[1], args.cs[2], args.cs[3])
            print(f"Written cross-section file: '{path}'")
            return 0
        print(
            'Usage: pbay-tpu -cs hitran FILE [TSTEP [WSTEP]] | '
            '-cs borysow FILE SPECIES1 SPECIES2'
        )
        return 1

    from .compile_cache import enable_compile_cache
    enable_compile_cache()

    if args.post is not None:
        from .retrieval.driver import posterior_post_processing
        posterior_post_processing(
            args.post, suffix=args.suffix, root=args.root,
        )
        return 0

    if args.cfile is None:
        parser.print_help()
        return 1

    from .driver import run
    run(args.cfile, root=args.root)
    return 0


if __name__ == '__main__':
    sys.exit(main())

# Adapted from the reference Makefile: the sweep lists, CSV target names and
# .bak/.cp caching pattern ARE the experiment protocol (SURVEY §2.1 #21), so
# variable names and rule structure intentionally mirror the original; the
# voronoi->cluster-colors.bak copy-paste bug is deliberately not reproduced.
# Experiment matrix driver (reference Makefile rebuilt for cniic-tpu).
#
# Same sweep lists, same CSV-per-codec protocol, same `.bak`/`.cp` result
# caching for the slow codecs, same tracked diagram targets.

all: data output

clean:
	rm -r data output

data:
	mkdir -p data

output:
	mkdir -p output

# https://data.vision.ee.ethz.ch/cvl/DIV2K/  (no egress in CI images: drop
# the zip into data/ by hand, or use `make synth-corpus`)
data/DIV2K_valid_HR.zip:
	wget -P data/ http://data.vision.ee.ethz.ch/cvl/DIV2K/DIV2K_valid_HR.zip

data/DIV2K_valid_HR: data/DIV2K_valid_HR.zip
	unzip data/DIV2K_valid_HR.zip -d data/

# Deterministic synthetic stand-in corpus when DIV2K can't be fetched
synth-corpus:
	python scripts/make_synth_corpus.py data/synth 24

# DIV2K-shaped corpus: 20 x 2040x1356 natural-statistics images (1/f^1.8
# spectra, correlated chroma, flat patches) — the parity-table corpus
div2k-shaped-corpus:
	python scripts/make_synth_corpus.py data/div2k_shaped 20 --div2k

# The golden-fixture 3840x2160 image (tests/test_golden_4k.py regenerates
# it in-process; this target materializes the PNG for hardware runs)
synth-4k:
	python scripts/make_synth_corpus.py data/4k --4k

# Textured night-statistics corpus: brackets the lossy chart magnitudes
# (VERDICT r3 #4) — the natural corpus remains the lossless-chart stand-in
textured-corpus:
	python scripts/make_synth_corpus.py data/textured 12 --textured

# Proxy-tuned corpus (VERDICT r4 #4): textured statistics at brightness
# 0.80 so the grid-cell-variance proxy (~3,000-3,300) lands the voronoi
# codec inside the reference chart's 4,200-6,500 MSE band
midtex-corpus:
	python scripts/make_synth_corpus.py data/midtex 12 --midtex

# North-star corpus: 1000 mixed-statistics 1024^2 images (40% natural /
# 30% gradient+patch / 30% textured) at BASELINE.md's specified scale —
# per-index seeded, so a killed generation resumes (VERDICT r4 #1)
ns-corpus:
	python scripts/make_synth_corpus.py data/ns1000 1000 --ns

# Whole-matrix sweep with the device/host overlapped driver (VERDICT r3
# #7: measured 1.39x over serial on the textured matrix, CSVs identical)
sweep-overlapped:
	python scripts/run_sweep.py --batch=8 --out=output $(DATASET)

# The north-star measurement at its own scale (BASELINE.md): all nine
# codecs steady-state over the 1000-image corpus, checkpointed after
# every chunk (--resume continues a killed run); writes northstar.json.
northstar:
	python scripts/experiments/northstar.py --chunk=32 \
	    --out=northstar.json --baseline=BASELINE_HOST_NS.json \
	    --resume 'data/ns1000/*.png'

LOSSLESS_DIAGRAM = output/boxplot.png
LOSSY_DIAGRAM = output/error_vs_compression.png
TRACKED_DIAGRAMS = lossy_status.png lossless_status.png

RUN = python -m cniic_tpu --batch=8
DATASET = data/DIV2K_valid_HR/*

LOSSLESS_CODECS = $(HUFMAN) $(ZIP_DICT) $(ZIP_BACK_CP) $(HILBERT)
HUFMAN = output/Hufman.csv
ZIP_DICT = output/zip-dict.csv
ZIP_BACK_ROOT = output/zip-back.csv
ZIP_BACK_CP = $(ZIP_BACK_ROOT).cp
HILBERT = output/hilbert-rle.csv output/hilbert-zip.csv output/delta.csv

LOSSY_CODECS = $(CLUSTER_COLORS) $(VORONOI) $(HILBERT_APPROX)
CLUSTER_COLORS = output/cluster-colors_16.csv.cp output/cluster-colors_32.csv.cp output/cluster-colors_64.csv.cp \
	output/cluster-colors_128.csv.cp output/cluster-colors_256.csv.cp
VORONOI = output/voronoi_64.csv.cp output/voronoi_128.csv.cp output/voronoi_256.csv.cp output/voronoi_512.csv.cp \
	output/voronoi_1024.csv.cp output/voronoi_2048.csv.cp
HILBERT_APPROX = output/hilbert-rle-approx_1.csv output/hilbert-rle-approx_2.csv output/hilbert-rle-approx_4.csv \
	output/hilbert-rle-approx_8.csv output/hilbert-rle-approx_16.csv

diagrams: $(TRACKED_DIAGRAMS)

lossless_status.png: $(LOSSLESS_DIAGRAM)
	cp $(LOSSLESS_DIAGRAM) lossless_status.png

lossy_status.png: $(LOSSY_DIAGRAM)
	cp $(LOSSY_DIAGRAM) lossy_status.png

PYTHON3 = PYTHONPATH="$(PYTHONPATH):scripts/" python3
SCRIPTS_LOC = scripts/diagrams

$(LOSSLESS_DIAGRAM): $(LOSSLESS_CODECS) $(SCRIPTS_LOC)/boxplot.py
	$(PYTHON3) $(SCRIPTS_LOC)/boxplot.py

$(LOSSY_DIAGRAM): $(LOSSLESS_CODECS) $(LOSSY_CODECS) $(SCRIPTS_LOC)/error_vs_compression_plot.py
	$(PYTHON3) $(SCRIPTS_LOC)/error_vs_compression_plot.py

$(HUFMAN):
	$(RUN) --codec=hufman $(DATASET)

# slow codecs keep a .bak so multi-hour runs aren't repeated (the .cp
# restores the live CSV from the .bak, so it only needs the .bak: from a
# clean output/ the bare CSV has no rule of its own and would otherwise
# block the pattern match)
output/%.cp: output/%.bak
	cp output/$*.bak output/$*
	touch output/$*.cp

output/cluster-colors_%.csv.bak:
	$(RUN) --codec="cluster-colors($*)" $(DATASET)
	cp output/cluster-colors_$*.csv output/cluster-colors_$*.csv.bak

output/voronoi_%.csv.bak:
	$(RUN) --codec="voronoi($*)" $(DATASET)
	cp output/voronoi_$*.csv output/voronoi_$*.csv.bak

$(ZIP_DICT):
	$(RUN) --codec="zip(dict)" $(DATASET)

$(ZIP_BACK_ROOT).bak:
	$(RUN) --codec="zip(back)" $(DATASET)
	cp $(ZIP_BACK_ROOT) $(ZIP_BACK_ROOT).bak

output/hilbert-rle.csv:
	$(RUN) --codec="hilbert(rle)" $(DATASET)

output/hilbert-rle-approx_%.csv:
	$(RUN) --codec="hilbert(rle($*))" $(DATASET)

output/hilbert-zip.csv:
	$(RUN) --codec="hilbert(zip)" $(DATASET)

output/delta.csv:
	$(RUN) --codec="delta" $(DATASET)

test:
	python -m pytest tests/ -q

bench:
	python bench.py

# decode-path fuzzing against an address-sanitized build of the C engines
# (VERDICT r3 #5): any C bounds miss aborts the run with an ASan report.
# cluster/voronoi are excluded: their decode C surface (Huffman, bit
# layer, unframe) is fully covered via the other families, and jaxlib's
# nanobind C++ throws trip ASan's __cxa_throw interceptor the moment a
# device computation runs under LD_PRELOAD.
asan-fuzz:
	cc -O1 -g -fPIC -shared -fsanitize=address -fno-omit-frame-pointer \
	    -o /tmp/libcniic_asan.so cniic_tpu/native/cniic_native.c -lm
	LD_PRELOAD=$$(cc -print-file-name=libasan.so) \
	    ASAN_OPTIONS=detect_leaks=0 \
	    CNIIC_NATIVE_LIB=/tmp/libcniic_asan.so \
	    python -m pytest tests/test_fuzz_decode.py -q \
	    -k "not cluster and not voronoi"

.PHONY: all clean diagrams synth-corpus synth-4k textured-corpus midtex-corpus ns-corpus sweep-overlapped test bench asan-fuzz

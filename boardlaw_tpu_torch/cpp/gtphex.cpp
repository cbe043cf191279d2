// gtphex — a small GTP-speaking Hex engine, bundled as the framework's
// baseline external opponent (MoHex stand-in for environments where the
// MoHex binary is unavailable; reference counterpart: the MoHex process the
// reference drives through boardlaw/mohex.py:66-151).
//
// Protocol: the subset of GTP the boardlaw_tpu.mohex client speaks —
//   name, version, boardsize N, clear_board, play <color> <vertex>,
//   loadsgf <file>, genmove <color>, reg_genmove <color>, showboard, quit —
// plus `param_* ...` accepted as no-ops so MoHex config scripts don't error.
//
// Play policy: if an immediate winning move exists, take it; otherwise pick
// the move with the best uniform-random-playout win rate (playouts
// configurable via `param_gtphex playouts N`, default 64; deterministic via
// --seed=N). Board convention matches MoHex: vertex "a1" = column a, row 1;
// black connects the top row to the bottom row, white connects the left
// column to the right column.
//
// Build: g++ -O2 -std=c++17 -o gtphex gtphex.cpp (boardlaw_tpu.gtp_engine
// does this on demand and caches the binary).
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <fstream>
#include <iostream>
#include <sstream>
#include <string>
#include <vector>

namespace {

struct Rng {  // splitmix64: tiny, deterministic, good enough for playouts
    uint64_t s;
    explicit Rng(uint64_t seed) : s(seed) {}
    uint64_t next() {
        uint64_t z = (s += 0x9e3779b97f4a7c15ull);
        z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
        z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
        return z ^ (z >> 31);
    }
    int below(int n) { return static_cast<int>(next() % static_cast<uint64_t>(n)); }
};

// union-find over cells + 4 virtual edge nodes
struct Dsu {
    std::vector<int> p;
    void reset(int n) {
        p.resize(n);
        for (int i = 0; i < n; ++i) p[i] = i;
    }
    int find(int x) {
        while (p[x] != x) x = p[x] = p[p[x]];
        return x;
    }
    void join(int a, int b) { p[find(a)] = find(b); }
};

struct Board {
    int size = 11;
    std::vector<int> cells;  // 0 empty, 1 black, 2 white
    Dsu dsu;
    int TOP, BOT, LEFT, RIGHT;

    void clear(int n) {
        size = n;
        cells.assign(size * size, 0);
        TOP = size * size;
        BOT = TOP + 1;
        LEFT = TOP + 2;
        RIGHT = TOP + 3;
        dsu.reset(size * size + 4);
    }

    static const int DR[6], DC[6];

    void connect(int r, int c, int color) {
        int id = r * size + c;
        if (color == 1) {
            if (r == 0) dsu.join(id, TOP);
            if (r == size - 1) dsu.join(id, BOT);
        } else {
            if (c == 0) dsu.join(id, LEFT);
            if (c == size - 1) dsu.join(id, RIGHT);
        }
        for (int k = 0; k < 6; ++k) {
            int nr = r + DR[k], nc = c + DC[k];
            if (nr < 0 || nr >= size || nc < 0 || nc >= size) continue;
            if (cells[nr * size + nc] == color) dsu.join(id, nr * size + nc);
        }
    }

    void play(int r, int c, int color) {
        cells[r * size + c] = color;
        connect(r, c, color);
    }

    int winner() {  // 0 none, 1 black, 2 white
        if (dsu.find(TOP) == dsu.find(BOT)) return 1;
        if (dsu.find(LEFT) == dsu.find(RIGHT)) return 2;
        return 0;
    }
};
const int Board::DR[6] = {-1, 1, 0, 0, -1, 1};
const int Board::DC[6] = {0, 0, -1, 1, 1, -1};

struct Engine {
    Board board;
    Rng rng;
    int playouts = 64;

    explicit Engine(uint64_t seed) : rng(seed) { board.clear(11); }

    std::vector<int> empties() const {
        std::vector<int> e;
        for (int i = 0; i < board.size * board.size; ++i)
            if (board.cells[i] == 0) e.push_back(i);
        return e;
    }

    // win rate of `color` after it plays `move`, by uniform random fill-out.
    // Hex never draws: a full board has exactly one winner, so playing out
    // to a full random fill and checking the connection decides every game.
    double winrate(int move, int color) {
        std::vector<int> base = empties();
        int wins = 0;
        for (int p = 0; p < playouts; ++p) {
            Board b = board;
            b.play(move / b.size, move % b.size, color);
            std::vector<int> pool;
            pool.reserve(base.size());
            for (int cell : base)
                if (cell != move) pool.push_back(cell);
            // shuffle and alternate colors starting with the opponent
            for (int i = static_cast<int>(pool.size()) - 1; i > 0; --i)
                std::swap(pool[i], pool[rng.below(i + 1)]);
            int turn = 3 - color;
            for (int cell : pool) {
                b.play(cell / b.size, cell % b.size, turn);
                turn = 3 - turn;
            }
            if (b.winner() == color) ++wins;
        }
        return static_cast<double>(wins) / playouts;
    }

    int choose(int color) {
        std::vector<int> moves = empties();
        if (moves.empty()) return -1;
        // immediate win if available (makes forced positions deterministic)
        for (int m : moves) {
            Board b = board;
            b.play(m / b.size, m % b.size, color);
            if (b.winner() == color) return m;
        }
        int best = moves[rng.below(static_cast<int>(moves.size()))];
        double best_rate = -1.0;
        for (int m : moves) {
            double r = winrate(m, color);
            if (r > best_rate) {
                best_rate = r;
                best = m;
            }
        }
        return best;
    }
};

int parse_color(const std::string& s) {
    if (s.empty()) return 0;
    char c = static_cast<char>(tolower(s[0]));
    return c == 'b' ? 1 : c == 'w' ? 2 : 0;
}

bool parse_vertex(const std::string& v, int size, int* r, int* c) {
    if (v.size() < 2) return false;
    int col = tolower(v[0]) - 'a';
    int row = atoi(v.c_str() + 1) - 1;
    if (col < 0 || col >= size || row < 0 || row >= size) return false;
    *r = row;
    *c = col;
    return true;
}

std::string vertex(int r, int c) {
    std::string s(1, static_cast<char>('a' + c));
    return s + std::to_string(r + 1);
}

}  // namespace

int main(int argc, char** argv) {
    uint64_t seed = 0x5eed;
    for (int i = 1; i < argc; ++i)
        if (strncmp(argv[i], "--seed=", 7) == 0) seed = strtoull(argv[i] + 7, nullptr, 10);

    Engine eng(seed);
    std::string line;
    while (std::getline(std::cin, line)) {
        std::istringstream in(line);
        std::string cmd;
        in >> cmd;
        if (cmd.empty()) continue;

        std::string out = "";
        bool ok = true;

        if (cmd == "name") {
            out = "gtphex";
        } else if (cmd == "version") {
            out = "1.0";
        } else if (cmd == "quit") {
            std::cout << "=\n\n" << std::flush;
            break;
        } else if (cmd == "boardsize") {
            int n = 0;
            in >> n;
            if (n >= 2 && n <= 19) eng.board.clear(n);
            else { ok = false; out = "unacceptable size"; }
        } else if (cmd == "clear_board") {
            eng.board.clear(eng.board.size);
        } else if (cmd == "play") {
            std::string col, v;
            in >> col >> v;
            int color = parse_color(col), r, c;
            if (color && parse_vertex(v, eng.board.size, &r, &c) &&
                eng.board.cells[r * eng.board.size + c] == 0) {
                eng.board.play(r, c, color);
            } else { ok = false; out = "illegal move"; }
        } else if (cmd == "loadsgf") {
            std::string path;
            in >> path;
            std::ifstream f(path);
            if (!f) { ok = false; out = "cannot open file"; }
            else {
                std::stringstream ss;
                ss << f.rdbuf();
                std::string sgf = ss.str();
                size_t sz = sgf.find("SZ[");
                int n = sz == std::string::npos ? eng.board.size
                                                : atoi(sgf.c_str() + sz + 3);
                eng.board.clear(n);
                for (size_t i = 0; i + 1 < sgf.size(); ++i) {
                    if ((sgf[i] == 'B' || sgf[i] == 'W') && sgf[i + 1] == '[') {
                        size_t end = sgf.find(']', i);
                        if (end == std::string::npos) continue;
                        std::string v = sgf.substr(i + 2, end - i - 2);
                        int r, c;
                        if (parse_vertex(v, eng.board.size, &r, &c))
                            eng.board.play(r, c, sgf[i] == 'B' ? 1 : 2);
                        i = end;
                    }
                }
            }
        } else if (cmd == "genmove" || cmd == "reg_genmove") {
            std::string col;
            in >> col;
            int color = parse_color(col);
            if (!color) { ok = false; out = "invalid color"; }
            else {
                int m = eng.choose(color);
                if (m < 0) out = "pass";
                else {
                    if (cmd == "genmove")
                        eng.board.play(m / eng.board.size, m % eng.board.size, color);
                    out = vertex(m / eng.board.size, m % eng.board.size);
                }
            }
        } else if (cmd == "showboard") {
            // 3 header lines + board + 1 footer, like MoHex (the client's
            // display() slices splitlines()[3:-1]); GTP responses may not
            // contain blank lines, so headers are non-empty
            std::ostringstream b;
            b << "\ngtphex\nsize " << eng.board.size << "\n";
            for (int r = 0; r < eng.board.size; ++r) {
                for (int c = 0; c < eng.board.size; ++c) {
                    int x = eng.board.cells[r * eng.board.size + c];
                    b << (x == 0 ? '.' : x == 1 ? 'B' : 'W');
                }
                b << "\n";
            }
            b << "--";
            out = b.str();
        } else if (cmd == "param_gtphex") {
            std::string k;
            int v;
            in >> k >> v;
            if (k == "playouts" && v > 0) eng.playouts = v;
        } else if (cmd.rfind("param_", 0) == 0) {
            // accept-and-ignore MoHex config params so config scripts run
        } else {
            ok = false;
            out = "unknown command";
        }

        // exactly one blank line terminates a GTP response
        while (!out.empty() && out.back() == '\n') out.pop_back();
        std::cout << (ok ? "= " : "? ") << out << "\n\n" << std::flush;
    }
    return 0;
}
